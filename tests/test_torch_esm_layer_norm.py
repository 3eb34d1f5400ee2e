"""ESM2's LayerNorm route (`ops/esm_layer_norm.py`) on the CPU.

The wrapper on a CPU tensor is `modules.layer_norm` rounded once to the
output dtype, bit for bit what `layer_norm(...).to(dt)` gave; a tiny ESM2
in eval mode with the kernel route forced calls it once a LayerNorm (two a
layer and the final one) and in train mode never; the forward and the
masked-LM head's logits are bitwise what the LayerNorm-then-cast form
gave.  Torch-only.  The kernel's own tests, on the card, are in
tests/test_torch_kernels.py (`-m gpu -k esm_layer_norm`).
"""

import pytest
import torch

from abx_tpu_torch.models import esm as port_esm
from abx_tpu_torch.models.modules import layer_norm
from abx_tpu_torch.ops import esm_attention as esm_attention_op
from abx_tpu_torch.ops import esm_layer_norm as esm_ln_op
from abx_tpu_torch.ops import registry

CFG = port_esm.ESM2Config.tiny()


def _ln_case(seed, shape, dtype):
    g = torch.Generator().manual_seed(seed)
    d = shape[-1]
    # An offset mean, as in a residual stream, so the one-pass variance's
    # cancellation is exercised.
    x = (torch.randn(shape, generator=g) * 2.0 + 0.5).to(dtype)
    w = (1.0 + 0.1 * torch.randn(d, generator=g)).to(dtype)
    b = (0.1 * torch.randn(d, generator=g)).to(dtype)
    return x, w, b


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_is_layer_norm_then_cast(dtype):
    """Bit for bit `layer_norm(x, w, b, eps).to(dtype)` at D = 64 and 480
    (ESM2 tiny and t12) with eps 1e-5 (the layers) and 1e-6 (the final LN
    and the LM head); the CPU call counts no launch."""
    before = esm_ln_op.esm_layer_norm.launches
    for d in (64, 480):
        x, w, b = _ln_case(d, (3, 7, d), dtype)
        for eps in (1e-5, 1e-6):
            got = esm_ln_op.esm_layer_norm(x, w, b, eps, dtype)
            want = layer_norm(x, w, b, eps).to(dtype)
            assert got.dtype == dtype
            assert torch.equal(got, want), (d, eps)
    assert esm_ln_op.esm_layer_norm.launches == before


def _tiny(dtype, seed=0):
    """A tiny ESM2 and its LM head with random weights (LayerNorm scales
    near 1) and a batch of tokens, the second row padded."""
    g = torch.Generator().manual_seed(seed)
    esm = port_esm.ESM2(CFG, dtype)
    head = port_esm.ESM2LMHead(CFG, dtype)
    with torch.no_grad():
        for name, p in [*esm.named_parameters(), *head.named_parameters()]:
            noise = torch.randn(p.shape, generator=g)
            if 'layer_norm' in name and name.endswith('weight'):
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.1 * noise)
    tokens = torch.randint(4, 24, (2, 13), generator=g)
    tokens[:, 0] = port_esm.ESM_CLS
    tokens[0, -1] = port_esm.ESM_EOS
    tokens[1, -4] = port_esm.ESM_EOS
    tokens[1, -3:] = port_esm.ESM_PAD
    tokens[0, 5] = port_esm.ESM_MASK
    return esm.eval(), head.eval(), tokens


def _outputs(esm, head, tokens):
    """Every ESM2 output mode and the LM head's logits on the final one."""
    lw = torch.linspace(0.5, 1.5, CFG.num_layers + 1)
    with torch.no_grad():
        final = esm(tokens, final_only=True)
        return [esm(tokens), final, esm(tokens, layer_weights=lw),
                head(final, esm.embed_tokens.weight)]


def _force_route(monkeypatch, spy=None):
    """The kernel route on the CPU: `on_device` forced true, the attention
    wrapper swapped for its plain version and the LayerNorm wrapper for
    `spy` (its plain version by default)."""
    monkeypatch.setattr(registry, 'on_device', lambda x: True)
    monkeypatch.setattr(port_esm, 'esm_attention',
                        esm_attention_op.esm_attention_plain)
    monkeypatch.setattr(port_esm, 'esm_layer_norm',
                        spy or esm_ln_op.esm_layer_norm_plain)


def test_esm2_calls_the_wrapper_once_a_layer_norm_in_eval_only(monkeypatch):
    """With the kernel route forced: an eval-mode forward calls the wrapper
    2 x layers + 1 times, the LM head once; in train mode (two-pass layer
    LNs, and no kernel route for the final one) never."""
    calls = []

    def spy(*args):
        calls.append(args[-1])
        return esm_ln_op.esm_layer_norm_plain(*args)
    _force_route(monkeypatch, spy)
    esm, head, tokens = _tiny(torch.bfloat16)
    with torch.no_grad():
        final = esm(tokens, final_only=True)
        assert len(calls) == 2 * CFG.num_layers + 1
        head(final, esm.embed_tokens.weight)
    assert len(calls) == 2 * CFG.num_layers + 2
    assert set(calls) == {torch.bfloat16}
    calls.clear()
    esm.train()
    head.train()
    with torch.no_grad():
        head(esm(tokens, final_only=True), esm.embed_tokens.weight)
    assert calls == []


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_esm2_and_lm_head_outputs_bitwise_unchanged(monkeypatch, dtype):
    """The forward in all three output modes and the LM head's logits: the
    CPU route and the forced kernel route (wrapper as its plain version)
    give the bits of the LayerNorm-then-cast form the modules had."""
    esm, head, tokens = _tiny(dtype, seed=1)
    got = _outputs(esm, head, tokens)
    with monkeypatch.context() as m:
        _force_route(m)
        routed = _outputs(esm, head, tokens)

    def then_cast(self, x, two_pass=False, out_dtype=torch.float32):
        return layer_norm(x, self.weight, self.bias, self.eps,
                          two_pass=two_pass).to(out_dtype)
    monkeypatch.setattr(port_esm.ESMLayerNorm, 'forward', then_cast)
    want = _outputs(esm, head, tokens)
    for g, r, w in zip(got, routed, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
        assert torch.equal(r, w)
