#!/usr/bin/env python3
"""Start-up proof of the PyTorch port (abx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one H100.  Phases, each
fatal on failure:
  1. the device, and the card's name and power limit from nvidia-smi;
  2. build the CUDA kernels from abx_tpu_torch/csrc; the channel-major
     post's Hopper kernel on one 64-position tile against its bf16 plain
     version (its MN-major wgmma descriptor), at the rounding-point bars;
  3. each kernel against its plain PyTorch version at the flagship shapes
     (B=4, L=288; the channel-major post also at L=284, a partial tile a
     batch element, and ipa_pair_attend at L=287 with H=16, and at H=20,
     C=200 and H=12, C=36, shapes the wrapper cuts into several launches
     of its kernel, under the profiler nothing else but their layout
     copies; the profiled cases' device time a call is recorded): f32 to 1e-4 * max|ref|, bf16 against the f32 plain
     version to 3e-2 * max|ref| (the packed triangle attention and its
     column variant with ABX_TRI_ATTN_BF16_EXP on and off, against the
     plain version with the same exponent); kernel and plain times (median
     of CUDA event timings after warm-up, bf16), and the time of the one
     torch call that computes the same function where there is one (and
     esm_attention's, ipa_attention's, tri_mult_pre's, tri_mult_post's
     (both inputs), pair_bias_proj's, fused_transition's, the gate-fold
     post's, recycle_embed's and ipa_pair_attend's one call each launch one
     device kernel, under the profiler, and that of pair_bias_proj,
     fused_transition, the two posts on Hopper kernels of their own,
     recycle_embed and ipa_pair_attend is that kernel by name;
     tri_mult_pre and tri_mult_post, the triangle attentions,
     pair_bias_proj, fused_transition, the gate-fold post and
     recycle_embed take their weights packed, as the modules cache them;
     the row-linear cases, fused_transition and the gate-fold post print
     beside them the bare bf16 torch.matmul of their products as a
     yardstick, recycle_embed a bare torch.add of two bf16 pair tensors;
     esm_attention also at the masked-PLL batches of phase 11, B=32, L=122
     and B=8, L=109, no key padded, with its f32 call timed too;
     esm_flash_attention, the flash route's segment-masked kernel, at the
     ESM2-3B shape and the first PLL batch, held on every row, the padded
     ones included, and in bf16 also against its bf16 plain version (the
     stock TPU flash kernel's rounding points): the share of outputs that
     differ is printed, at most BF16_SHARE more than one bf16 step apart;
     its bf16 call launches the Hopper kernel of csrc/esm_flash_sm90.cu,
     by name, whose CTAs an SM, registers, local bytes and ptxas spill
     lines are printed first; its library call is SDPA with the segment
     mask as a boolean mask); esm_layer_norm (row 16, ESM2's LayerNorm)
     at the ESM2-3B design batch, 16 x 306 rows of 2560, held in bf16
     against its bf16 plain version as esm_flash_attention is, its one
     call one device kernel by name and its f32 call timed, beside
     torch.nn.functional.layer_norm as the library call,
     and row 1's attention core alone on ready projection rows beside
     SDPA; the bf16 core against the plain core with the TPU kernel's
     exponent (against the row's final max) on rows whose logits are exact
     in f32, to EXP_TOL relative; the bf16 Hopper kernels of tri_mult_pre
     (three variants), tri_mult_post (both inputs), the gate-fold post,
     gate_proj and ipa_pair_attend (also at the two split shapes) against
     their bf16 plain versions (the TPU kernels' rounding points):
     at most BF16_SHARE of the outputs differ, by at most BF16_STEPS, and a
     second call gives the same bits; the bf16 IPA scalar attend with p
     rounded to bf16 (the TPU kernel's p.astype(in_dt)) on a case where
     the rounding of p moves the output by 15-35%, to IPA_CANCEL_TOL
     relative; then
     the channel-major contraction (torch.matmul, checked under the
     profiler to run no copy kernel) timed beside the natural einsum and
     the triangle_multiply kernel, both orientations;
  4. one full-width f32 forward_with_recycling with every kernel flag off
     (dense random weights); each of its passes run again on the same
     inputs (the recycled ones included) with the default kernel flags on:
     rot_score, trans_score, logits and rigids agree to 1e-4 * max|ref| on
     valid rows in every pass;
  4c. the same in the opt-in kernel configuration (OPT_IN below);
  4d. the same with the default flags and ABX_TRIMULT_C_MAJOR=1;
  4b. one full-width f32 ESM2-3B forward of AntibodyESM (dense random
     weights, learned layer weights given) on the tokens of
     testdata/6ct7_H_L_S.pdb with ABX_FUSED_ESM_ATTN on and off, and on
     the flash route (ABX_FUSED_ESM_ATTN=0 ABX_FLASH_ESM=1): the weighted
     embedding agrees to 1e-4 * max|ref| on valid rows;
  5. a full-width bf16 ESM-off CDR-H3 design through
     abx_tpu_torch.cli.design (config/config_model.json, random weights from
     seed 0, 4 samples, num_t 8) on testdata/6ct7_H_L_S.pdb: 4 PDBs with
     chains H, L, S and finite coordinates, every trunk kernel launched the
     expected number of times (and esm_attention never), wall time, seconds
     per step, samples/hour; its output directory is kept for phase 11;
  6. the same design conditioned on ESM2-3B (random weights made on the
     card, runner.build_runtime(esm_random=True) + runner.run_sampling): 4
     PDBs, esm_attention launched 36 x 3 x (num_t + 1) times, esm_layer_norm
     (2 x 36 + 1) x 3 x (num_t + 1) times and the trunk kernels as in
     phase 5; then a second trajectory in the same process
     for the steady-state seconds per step;
  6b. phase 6's design on its runtime with the sampler's opt-in ESM reuse
     (the embedding refreshed at grid positions 0, 2, 4, 6 and 8) and two
     Gibbs-corrector jumps a step, through runner.run_sampling: 4 PDBs,
     esm_attention launched 36 x 5 = 180 times, esm_layer_norm 73 x 5,
     the trunk kernels as in phase 5;
  6c. phase 6's design on its runtime on the flash route
     (ABX_FUSED_ESM_ATTN=0 ABX_FLASH_ESM=1): 4 PDBs, esm_flash_attention
     launched 36 x 3 x (num_t + 1) = 972 times, esm_attention never,
     esm_layer_norm as in phase 6, the trunk kernels as in phase 5;
     seconds per step beside phase 6's;
  10. ESM-off Sampler.sample_resumable in chunks of 3 grid positions,
     whole, and killed as its second chunk starts (the first chunk's
     state on disk) and then resumed: sequences identical to
     Sampler.sample with the same generator seed, backbone within 0.1 A;
     the killed run and its resume launch each trunk kernel as one
     trajectory of phase 5 does;
  bench smoke: the bench's per-config function
     (abx_tpu_torch/tools/bench.py) on the runtimes already built, num_t
     2, one rep, for no_esm and esm_reuse; its JSON line is printed;
  7. full-width bf16 test-set CDR-H3 optimization through
     abx_tpu_torch.cli.inference (--mode optimize --optimize_steps 4
     --num_t 8, 4 samples, random weights from seed 0) over an npz
     directory of both test complexes, written by the port's
     data/dataset.py::complex_from_pdb, in the opt-in kernel configuration:
     4 PDBs per complex under OPT-4/ with the complex's chains and finite
     coordinates, every kernel launched the expected number of times (4
     reverse steps + the prime step, 3 trunk passes each, 2 complexes);
     then one trajectory-mode run at the default flags on 6ct7 (num_t 3),
     which writes one <name>@<t>.pdb per step;
  8. phase 5 again under ABX_TRIMULT_C_MAJOR=1: the channel-major
     tri_mult pre / post on every triangle multiplication, the natural ones
     never;
  9. ESM-off design through the design CLI with --use_seqres --verbose on
     a copy of testdata/6ct7_H_L_S.pdb with SEQRES records for chain H
     and residues 30-35 of H's ATOM records dropped: H of the npz schema
     from complex_from_pdb(use_seqres=True) as long as the intact
     structure's, the 6 residues present and unobserved; 4 PDBs; the
     trunk kernels as in phase 5;
  11. the evaluation path on phase 5's 4 designs: cli/relax_pdb.py on the
     card writes 4 `_relaxed.pdb` (chains H, L, S, finite coordinates,
     the relaxer's energy and its bond + clash violation not above their
     values before, every atom outside the CDRs unchanged; seconds per
     structure); cli/eval_violations.py on
     the card over them (4 finite rows) and cli/eval_metric.py over the
     designs (4 rows of results.csv, finite full_rmsd, H3 AAR in [0, 1]);
     masked PLL (evaluation/pll.py) of chains H and L of each design under
     ESM2-t36-3B with its LM head in f32, random weights made on the card:
     every PLL finite and <= 0, esm_attention launched 36 x the batches of
     32 masked copies and esm_layer_norm (2 x 36 + 1) + 1 (the LM head) x
     those batches (the `eval_pll` path; every trunk kernel 0); then
     cli/eval_pll.py on a random t12_35M-shaped fair-esm checkpoint with
     its LM head: the CSV, esm_attention launched 12 x the same batches,
     esm_layer_norm (2 x 12 + 1) + 1 x them;
  12. the training path in f32 at full width (B=4, L=288) on an npz
     directory of both test complexes written as in phase 7: ESM off
     through abx_tpu_torch.cli.train (random weights from seed 0), 4 steps
     with checkpoints every 2 and one metrics row a step, then --resume to
     a total of 6: rows 1-6 with finite `total` and `grad_norm` > 0, the
     raw weights moved from the initial ones and the EMA weights apart
     from the raw ones, params.pt{,.raw,.train} and no `.tmp`, no kernel
     launched (training takes the plain route); seconds per step (median
     of the steps that follow neither a run's first step nor a
     checkpoint save: steps 2, 4 and 6) and peak memory.  ESM2-3B on
     (random weights made on the card, frozen; runner + Trainer.fit, 3
     steps): esm_attention launched 36 x the trunk passes the steps drew,
     esm_layer_norm never (the Trainer's train mode), no ESM parameter
     with a gradient, the learned layer weights'
     gradient finite and nonzero; seconds per step (median of steps 2
     and 3), peak memory, and the last step's gradient norm with its
     largest leaves.  Then a bf16
     design (4 samples, num_t 8) through the design CLI from the EMA
     weights of the ESM-off run: 4 PDBs, the trunk kernels as in phase 5.
  13. the paths over processes and the Picard sampler (`picard_*`,
     `tp_esm`, `multihost_inference`, `dp_train`, `trace` in
     `launches_by_path`; several ranks share the one card as child
     processes of this script over gloo, each printing its launch counts
     on a result line, which the parent adds up):
     13a. picard_sample_prepared against Sampler.sample_prepared under the
       same injected noise: f32 (TF32 off, B=2, num_t 4) reaches delta 0
       within grid + 1 sweeps, sequences equal, backbone within 0.1 A,
       each trunk kernel per pass x 3 x sweeps; the bf16 flagship (B=4,
       num_t 8: 36 rows a sweep) prints its sweeps, deltas, seconds and
       agreement (not fatal), its launches as f32's;
     13b. tensor-parallel ESM2-3B over 2 ranks: the f32 weighted embedding
       (dense random weights from seed 0, phase 4b's inputs) within 1e-4
       x max|ref| of one process's AntibodyESM, esm_attention 36 and
       esm_layer_norm 73 a forward a rank; a bf16 ESM-conditioned design
       (num_t 2, 4 samples) with
       TensorParallelAntibodyESM as esm_fn through runner.sample_chunk:
       both ranks' bits identical, rank 0 writes 4 PDBs;
     13c. two cli/inference.py processes with --coordinator / --num_hosts
       / --host_id over the npz directory of both test complexes (bf16,
       num_t 4, 2 samples): disjoint cover, every output written once,
       one complex's launches a process;
     13d. two data-parallel Trainer steps over 2 ranks (f32, full width,
       dense random trunk weights, frozen ESM2-3B, global batch 4) against
       one process's step on the whole batch: loss within 1e-5 relative,
       summed gradients within 1e-4 of their max, weights after the update
       within 1e-4 x max|update| where the two runs' gradients determine
       Adam's first update to a tenth of that; seconds a step;
     13e. utils/prof.py's trace around one bf16 trunk pass under an
       annotate span: rows 1-7's device kernels inside the span.
  14. a released-checkpoint design: the flagship model (ESM off, random
     weights from seed 0, every weight moved by 0.02 N(0, 1) so that no
     AF2 zero init hides a mapping) written as a reference-format `.ckpt`
     (`{'model_state_dict': ...}` under the reference ScoreNetwork's names,
     utils/torch_convert.py::reference_state_dict) and as the port
     trainer's `params.pt`; cli/design.py --model on each (bf16, 4
     samples, num_t 4, seed 0): the design PDBs byte-identical, the
     trunk kernels launched per pass x 15 on the `.ckpt` run.
  15. the quality and rehearsal tools of abx_tpu_torch/tools at full width
     (`tools_*` in `launches_by_path`):
     15a. multi_train_rehearsal: the 16-complex corpus, cli/train.py in a
       subprocess (B=4, 8 steps, a checkpoint every 2) killed with SIGKILL
       once the step-4 checkpoint has landed, resumed to step 8; the EMA
       weights' 4 bf16 CDR designs of the held-out variant (num_t 4)
       finite, the trunk kernels per pass x 15;
     15b. overfit_6ct7: 2 steps with a frozen random ESM2 (6 x 320), then
       `--eval_only` with every `--eval_*` flag (ESM reuse, refresh 2,
       corrector at num_t 4, the fast recipe at num_t 25), each result key
       finite in f32 and bf16; the trunk kernels per pass and
       esm_attention and esm_layer_norm per ESM pass, counted over the 12
       evaluations;
     15c. revalidate_kernels on those weights, on the default route (the
       kernels of one evaluation) and with every kernel flag 0 (no
       launch but esm_layer_norm's, which has no flag); its verdict is
       printed, not judged (2-step weights);
     15d. probe_picard at num_t 4 (B=1, bf16): sweeps <= grid at both
       tolerances, the tol-0 fixpoint's sequences equal to the sequential
       run's and its backbone within 0.1 A, the trunk kernels per pass of
       every run.
Each main path (phases 5, 6, 6b, 6c, 7, 8, 9, 10, 11, 12, 13, 14, each of 15a-d
and the trajectory run) is driven with the launch counts set to 0 just
before it and read just after; phase 12's are `train_esm_off` (both runs),
`train_esm_on` and `design_trained` in `launches_by_path`.  The lines
before the last are the nvidia-smi card line and the kernels JSON (each
kernel's launches on each main path in `launches_by_path`, and in
`launches` the largest of them, its error, its time, its plain
version's time, the least time the card could take for the same work and
the time of the torch call that computes the same function, where there
is one); the last line is the result JSON.  triangle_attention_fused and
triangle_attention_packed_cols are on no main path (the JAX package wires
neither): phase 3 is what holds them.  The kernels are built with one nvcc
per source, all started together.  No JAX is imported.
"""

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PDB = os.path.join(HERE, 'testdata', '6ct7_H_L_S.pdb')
TEST_SET = [PDB, os.path.join(HERE, 'testdata', '6qd7_X_Z_F|E.pdb')]
MODEL_CONFIG = os.path.join(HERE, 'config', 'config_model.json')
F32_TOL, BF16_TOL = 1e-4, 3e-2
TIMING_REPS = 7
# NVIDIA's published H100 SXM peaks at 700 W (dense bf16 tensor-core rate,
# HBM3 bandwidth): the least time for a kernel's work is the larger of its
# operations over the first and its bytes over the second.
PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 989e12, 3.35e12


def fail(msg):
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f'nvidia-smi failed: {out.stderr.strip()}')
    return out.stdout.strip().splitlines()[0].strip()


def time_ms(torch, fn, reps=TIMING_REPS):
    """Median of `reps` CUDA-event timings of fn() after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got, want):
    """(max |got - want|, max |want|) in f32."""
    d = (got.float() - want.float()).abs().max().item()
    return d, want.float().abs().max().item()


def tensor_bytes(tensors):
    """Bytes of the distinct tensors (each read or written once)."""
    seen = {}
    for t in tensors:
        seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def bound_ms(flops, nbytes):
    """(least time in ms, 'operations' or 'bytes'): bf16 tensor-core peak
    for the products, HBM bandwidth for the bytes."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


def bound_ms_f32(flops, nbytes):
    """bound_ms of an f32 call of a kernel whose f32 products run as
    bf16x3 on the tensor cores (three bf16 products a product: the flash
    core of csrc/flash_attention.cuh), its bytes at 4 a value."""
    return bound_ms(3 * flops, nbytes)


def kernel_cases(torch, dev):
    """One dict per case at the flagship shapes of one trunk pass (B=4,
    L=288, bf16 trunk) and of one ESM2-3B layer (B=4, L=306, 40 heads):
    name, label, kernel and plain fns, f32 and bf16 args, the other
    tensors the function reads, its tensor-core FLOPs, and the one torch
    call that computes the same function (or None)."""
    from abx_tpu_torch.ops import esm_attention as esm_op
    from abx_tpu_torch.ops import esm_layer_norm as eln_op
    from abx_tpu_torch.ops import gate_proj as gp_op
    from abx_tpu_torch.ops import ipa_attend as ia_op
    from abx_tpu_torch.ops import ipa_attention as ipa_op
    from abx_tpu_torch.ops import pair_bias as pb_op
    from abx_tpu_torch.ops import recycle_embed as re_op
    from abx_tpu_torch.ops import transition as tr_op
    from abx_tpu_torch.ops import tri_attention as ta_op
    from abx_tpu_torch.ops import tri_mult as tm_op
    from abx_tpu_torch.ops import triangle as tg_op
    g = torch.Generator(device=dev).manual_seed(0)
    b, l = 4, 288
    m = b * l * l

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    mask = torch.ones(b, l, device=dev)
    mask[:, -9:] = 0.0
    mask[1, 100] = 0.0
    cases = []

    def case(name, label, kern, plain, a32, a16, reads, flops, library=None,
             env=None, plain16=None, one_launch=False, gemm=None,
             kernel_name=None, stream=None, split=None, time32=False,
             share16=False):
        """env: flags set while the case runs; plain16: the plain version
        the bf16 kernel is held to, where it differs from `plain`;
        one_launch: the wrapper must launch its kernel and no other device
        kernel (checked under the profiler), whose name holds kernel_name
        where given; gemm: [(k, n), ...] of the bare bf16 torch.matmul
        products (M, k) x (k, n), timed together beside the kernel as a
        yardstick (not the same function: no LayerNorm, no epilogue);
        stream: (label, fn) of a bare torch call that streams about the
        bytes the kernel moves, timed beside it as a yardstick of the rate
        the card streams at (not the same function); split: (kernel_name,
        launches) of a call that the wrapper cuts into several launches:
        under the profiler one call runs that kernel that many times and
        nothing else but the split's layout copies and fills; time32: the
        f32 call is timed too (kernel, plain, library and its bound), where
        a main path runs the kernel in f32; share16: the bf16 call is held
        to the plain version run in bf16 too (the rounding points of the
        function it ports): at most BF16_SHARE of the outputs more than one
        bf16 step apart, the share that differ at all printed."""
        cases.append(dict(name=name, label=label, kern=kern, plain=plain,
                          a32=a32, a16=a16, reads=reads, flops=flops,
                          library=library, env=env or {}, plain16=plain16,
                          one_launch=one_launch, gemm=gemm,
                          kernel_name=kernel_name, stream=stream,
                          split=split, time32=time32, share16=share16))

    def tri(label, r, c, h, exp_flag):
        x = rnd(b, r, l, c)
        w = [rnd(c, c, scale=c ** -0.5) for _ in range(5)]
        kw = dict(ln=(1 + rnd(c, scale=0.1), rnd(c, scale=0.1)),
                  gate=(w[3], rnd(c, scale=0.1)),
                  out_proj=(w[4], rnd(c, scale=0.1)))
        bias = rnd(b, h, l, l)
        args = (x, w[0], w[1], w[2], bias, mask)
        # The packed weights, as the module caches them.
        packs = {dt: ta_op.pack_projection(w[0], w[1], w[2], c // h, dt,
                                           **kw)
                 for dt in (torch.float32, torch.bfloat16)}
        rows = b * r * l
        # q/k/v/gate and out projections; QK^T and PV over H heads of D.
        flops = 10 * rows * c * c + 4 * b * r * l * l * c
        case('triangle_attention_packed', f'{label}, bf16 exp {exp_flag}',
             lambda x, res: ta_op.triangle_attention_packed(
                 x, *args[1:], residual=res, packed=packs[x.dtype], **kw),
             lambda x, res: ta_op.triangle_attention_packed_plain(
                 x, *args[1:], residual=res, **kw),
             (x, x), (x.bfloat16(), x.bfloat16()),
             [*w, bias, mask, *kw['ln'], kw['gate'][1], kw['out_proj'][1]],
             flops, env={'ABX_TRI_ATTN_BF16_EXP': exp_flag},
             plain16=lambda x, res: ta_op.triangle_attention_packed_plain(
                 x, *args[1:], residual=res, bf16_exp=exp_flag == '1',
                 **kw), gemm=[(c, 4 * c)] if r > 1 else None)
    tri('tri-attention (4,288,288,192) H=4 D=48', l, 192, 4, '1')
    tri('tri-attention (4,288,288,192) H=4 D=48', l, 192, 4, '0')
    tri('seq-attention (4,1,288,544) H=32 D=17', 1, 544, 32, '1')

    # Row 1's attention core alone, on ready projection rows y [q | k | v |
    # gate] of the tri shape, as the wrapper launches it (so the table can
    # split row 1 into core and projections).  Its library call is SDPA on
    # views of y with bias + key-mask bias as one additive bf16 mask,
    # materialised (B*R, H, L, L) before the timed call, and without the
    # gate's multiply.
    h, d = 4, 48
    hd = h * d
    shape = (b, l, l, h, d)
    y = torch.cat([rnd(b * l * l, hd, scale=d ** -0.5),
                   rnd(b * l * l, 3 * hd)], 1)
    cbias = rnd(b, h, l, l)
    cbias16 = cbias.bfloat16()
    sdpa_bias = cbias16.float() + ((1.0 - mask) * -1e9)[:, None, None, :]
    core_mask = sdpa_bias.bfloat16()[:, None].expand(b, l, h, l, l).reshape(
        b * l, h, l, l)
    del sdpa_bias

    def core_sdpa(y, b=b, l=l, h=h, d=d):
        q, k, v = (y[:, i * h * d:(i + 1) * h * d].view(b * l, l, h, d)
                   .transpose(1, 2) for i in range(3))
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=core_mask, scale=1.0)
    case('triangle_attention_packed',
         'core alone on a ready y (4*288*288, 768), H=4 D=48, gated, bf16 '
         'exp 1; library SDPA without the gate',
         lambda y, shape=shape: ta_op.tri_attention_core(
             y, shape, cbias16 if y.dtype == torch.bfloat16 else cbias,
             mask, True, bf16_exp=True),
         lambda y, shape=shape: ta_op.tri_attention_core_plain(
             y, shape, cbias, mask, True),
         (y,), (y.bfloat16(),), [cbias16, mask], 4 * b * l * l * l * hd,
         core_sdpa,
         plain16=lambda y, shape=shape: ta_op.tri_attention_core_plain(
             y, shape, cbias, mask, True, bf16_exp=True))
    del y

    # pair_bias_proj and fused_transition take their weights packed, as the
    # modules cache them: then a bf16 call is one launch of the Hopper
    # kernel (f32 stays on the older generic kernels).
    for h in (4, 32):
        pair = rnd(b, l, l, 192)
        s, bb, w = 1 + rnd(192, scale=0.1), rnd(192, scale=0.1), rnd(
            h, 192, scale=192 ** -0.5)
        pb_pk = {dt: pb_op.pack_pair_bias(s, bb, w, dt)
                 for dt in (torch.float32, torch.bfloat16)}
        case('pair_bias_proj', f'(4,288,288,192) -> H={h}',
             lambda p, s=s, bb=bb, w=w, pk=pb_pk: pb_op.pair_bias_proj(
                 p, s, bb, w, packed=pk[p.dtype]),
             lambda p, s=s, bb=bb, w=w: pb_op.pair_bias_proj_plain(p, s, bb,
                                                                   w),
             (pair,), (pair.bfloat16(),), [s, bb, w], 2 * m * 192 * h,
             one_launch=True, kernel_name='pair_bias_kernel')

    x = rnd(b, l, l, 192)
    targs = (1 + rnd(192, scale=0.1), rnd(192, scale=0.1),
             rnd(768, 192, scale=192 ** -0.5), rnd(768, scale=0.1),
             rnd(192, 768, scale=768 ** -0.5), rnd(192, scale=0.1))
    tr_pk = {dt: tr_op.pack_transition(*targs, dt)
             for dt in (torch.float32, torch.bfloat16)}
    case('fused_transition', '(4,288,288,192) N=768',
         lambda x: tr_op.fused_transition(x, *targs, packed=tr_pk[x.dtype]),
         lambda x: tr_op.fused_transition_plain(x, *targs),
         (x,), (x.bfloat16(),), list(targs), 4 * m * 192 * 768,
         one_launch=True, kernel_name='transition_sm90_kernel',
         gemm=[(192, 768), (768, 192)])

    c, nc = 192, 128
    x = rnd(b, l, l, c)
    pre = (1 + rnd(c, scale=0.1), rnd(c, scale=0.1),
           rnd(4 * nc + c, c, scale=c ** -0.5), rnd(4 * nc + c, scale=0.5),
           mask)
    # The packed weights, as the module caches them (then a call is one
    # launch).
    pre_parts = (torch.split(pre[2], [nc] * 4 + [c]),
                 torch.split(pre[3], [nc] * 4 + [c]))
    pre_pk = {dt: tm_op.pack_pre(*pre_parts, pre[0], pre[1], dt)
              for dt in (torch.float32, torch.bfloat16)}
    case('tri_mult_pre', '(4,288,288,192) -> nc=128 x2 + 192',
         lambda x: tm_op.tri_mult_pre(x, *pre, packed=pre_pk[x.dtype]),
         lambda x: tm_op.tri_mult_pre_plain(x, *pre),
         (x,), (x.bfloat16(),), list(pre), 2 * m * c * (4 * nc + c),
         one_launch=True, gemm=[(c, 4 * nc + c)])
    case('tri_mult_pre_c_major', '(4,288,288,192) -> nc=128 x2 as '
         '(4,128,288,288) + 192',
         lambda x: tm_op.tri_mult_pre(x, *pre, c_major=True,
                                      packed=pre_pk[x.dtype]),
         lambda x: tm_op.tri_mult_pre_plain(x, *pre, c_major=True),
         (x,), (x.bfloat16(),), list(pre), 2 * m * c * (4 * nc + c))
    y, fg, res = rnd(b, l, l, nc), rnd(b, l, l, c), rnd(b, l, l, c)
    post = (1 + rnd(nc, scale=0.1), rnd(nc, scale=0.1),
            rnd(c, nc, scale=nc ** -0.5), rnd(c, scale=0.1))
    # The packed weights, as TriangleMultiplication caches them (then a call
    # is one launch).
    post_pk = {dt: tm_op.pack_post(*post, dt)
               for dt in (torch.float32, torch.bfloat16)}
    case('tri_mult_post', '(4,288,288,128) -> 192',
         lambda y, fg, res: tm_op.tri_mult_post(y, *post, fg, res,
                                                packed=post_pk[y.dtype]),
         lambda y, fg, res: tm_op.tri_mult_post_plain(y, *post, fg, res),
         (y, fg, res), (y.bfloat16(), fg.bfloat16(), res.bfloat16()),
         list(post), 2 * m * nc * c, one_launch=True, gemm=[(nc, c)])
    def post_cm(y, fg, res):
        return tm_op.tri_mult_post(y, *post, fg, res, y_c_major=True,
                                   packed=post_pk[y.dtype])

    def post_cm_plain(y, fg, res):
        return tm_op.tri_mult_post_plain(y, *post, fg, res, y_c_major=True)
    # At the flagship, and at L = 284: R*L a multiple of 8, not of 64, so the
    # last tile of each batch element is partial.
    for lo, what in ((l, ''), (284, ', a partial last tile a batch element')):
        ycm = (y.permute(0, 3, 1, 2).contiguous() if lo == l
               else rnd(b, nc, lo, lo))
        fgo, reso = (fg, res) if lo == l else (rnd(b, lo, lo, c),
                                               rnd(b, lo, lo, c))
        case('tri_mult_post_c_major',
             f'(4,128,{lo},{lo}) -> (4,{lo},{lo},192){what}', post_cm,
             post_cm_plain, (ycm, fgo, reso),
             (ycm.bfloat16(), fgo.bfloat16(), reso.bfloat16()), list(post),
             2 * b * lo * lo * nc * c, one_launch=True,
             kernel_name='post_cmajor_sm90_kernel')
        del ycm, fgo, reso
    pre4 = (pre[0], pre[1], pre[2][:4 * nc].contiguous(), pre[3][:4 * nc],
            mask)
    pre4_pk = {dt: tm_op.pack_pre(pre_parts[0][:4], pre_parts[1][:4],
                                  pre[0], pre[1], dt)
               for dt in (torch.float32, torch.bfloat16)}
    case('tri_mult_pre_no_fgate', '(4,288,288,192) -> nc=128 x2',
         lambda x: tm_op.tri_mult_pre(x, *pre4, emit_fgate=False,
                                      packed=pre4_pk[x.dtype]),
         lambda x: tm_op.tri_mult_pre_plain(x, *pre4, emit_fgate=False),
         (x,), (x.bfloat16(),), list(pre4), 2 * m * c * 4 * nc)
    fold = (1 + rnd(c, scale=0.1), rnd(c, scale=0.1),
            rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.5))
    # The packed weights, as TriangleMultiplication caches them (then a
    # bf16 call is one launch of the Hopper kernel).
    fold_pk = {dt: tm_op.pack_gatefold(*post, *fold, dt)
               for dt in (torch.float32, torch.bfloat16)}
    case('tri_mult_post_gatefold', '(4,288,288,128) + res 192 -> 192',
         lambda y, res: tm_op.tri_mult_post_gatefold(
             y, *post, *fold, res, packed=fold_pk[y.dtype]),
         lambda y, res: tm_op.tri_mult_post_gatefold_plain(y, *post, *fold,
                                                           res),
         (y, res), (y.bfloat16(), res.bfloat16()), list(post) + list(fold),
         2 * m * (nc * c + c * c), one_launch=True,
         kernel_name='gatefold_sm90_kernel', gemm=[(nc, c), (c, c)])
    hd = 192
    gy, gate = rnd(b, l, l, hd), rnd(b, l, l, hd, scale=2.0)
    gw = (rnd(c, hd, scale=hd ** -0.5), rnd(c, scale=0.1))
    case('gate_proj_residual', '(4,288,288,192) x gate -> 192 + res',
         lambda y, gt, res: gp_op.gate_proj_residual(y, gt, *gw, res),
         lambda y, gt, res: gp_op.gate_proj_residual_plain(y, gt, *gw, res),
         (gy, gate, res), (gy.bfloat16(), gate.bfloat16(), res.bfloat16()),
         list(gw), 2 * m * hd * c, gemm=[(hd, c)])
    del gy, gate
    left, right = rnd(b, l, l, nc), rnd(b, l, l, nc)
    for per_row, eq in ((True, 'bikc,bjkc->bijc'),
                        (False, 'bkic,bkjc->bijc')):
        case('triangle_multiply',
             f'(4,288,288,128) {"per_row" if per_row else "per_column"}',
             lambda lt, rt, pr=per_row: tg_op.triangle_multiply_kernel(
                 lt, rt, pr),
             lambda lt, rt, pr=per_row: tg_op.triangle_multiply_einsum(
                 lt, rt, pr),
             (left, right), (left.bfloat16(), right.bfloat16()), [],
             2 * b * l * l * l * nc,
             lambda lt, rt, eq=eq: torch.einsum(eq, lt, rt))
    del left, right
    # As EmbeddingAndSeqformer calls it: the (B, 32) time embedding in the
    # compute dtype on both index-embed blocks (its values exact in bf16, so
    # the f32 plain version sees the ones the bf16 call does), the params
    # packed in f32 as the module caches them.
    static, prev = rnd(b, l, l, 128), rnd(b, l, l, c, scale=2.0)
    t_emb = rnd(b, 32).bfloat16().float()
    t_of = {torch.float32: t_emb, torch.bfloat16: t_emb.bfloat16()}
    rec = (1 + rnd(c, scale=0.1), rnd(c, scale=0.1), rnd(15, c),
           torch.randint(0, 15, (b, l, l), generator=g, device=dev))
    rec_pk = re_op.pack_recycle(*rec[:3])
    prev2 = rnd(b, l, l, c).bfloat16()
    case('recycle_embed', '(4,288,288,128) + (4,288,288,192) -> 192, t (4,32) '
         'x2',
         lambda sp, pp: re_op.recycle_embed(sp, t_of[pp.dtype], pp, *rec,
                                            packed=rec_pk),
         lambda sp, pp: re_op.recycle_embed_plain(sp, t_emb, pp, *rec),
         (static, prev), (static.bfloat16(), prev.bfloat16()),
         [t_of[torch.bfloat16], *rec], 0, one_launch=True,
         kernel_name='recycle_kernel',
         stream=('torch.add of two (4,288,288,192) bf16',
                 lambda sp, pp: torch.add(pp, prev2)))

    # As the IPA module hands them in: k / v column blocks of one (B, L, H,
    # 2 Ds) projection, the bias the permuted (B, L, L, H) pair projection
    # in the compute dtype (its values exact in bf16, so the f32 call and
    # the plain version see the same ones).
    h, ds, pq, pv, c = 12, 16, 4, 8, 128
    qs, kv = rnd(b, l, h, ds, scale=0.25), rnd(b, l, h, 2 * ds, scale=0.25)
    kv16 = kv.bfloat16()
    pts = [rnd(b, l, h, p, 3, scale=3.0) for p in (pq, pq, pv)]
    pw = -0.5 * (0.1 + torch.rand(h, generator=g, device=dev)) * 0.2
    ibias16 = rnd(b, l, l, h).bfloat16().permute(0, 3, 1, 2)
    ibias, pair = ibias16.float(), rnd(b, l, l, c)
    ibias_of = {torch.float32: ibias, torch.bfloat16: ibias16}
    case('ipa_attention', 'pair (4,288,288,128) H=12, module layouts',
         lambda qs, ks, vs, pair: ipa_op.ipa_attention(
             qs, ks, vs, *pts, pw, ibias_of[qs.dtype], mask, pair),
         lambda qs, ks, vs, pair: ipa_op.ipa_attention_plain(
             qs, ks, vs, *pts, pw, ibias, mask, pair),
         (qs, kv[..., :ds], kv[..., ds:], pair),
         (qs.bfloat16(), kv16[..., :ds], kv16[..., ds:], pair.bfloat16()),
         [*pts, pw, ibias16, mask], one_launch=True, flops=(
             # logits (scalar + point terms), scalar / point / pair attends.
             2 * b * h * l * l * (2 * ds + 3 * pq + 3 * pv + c)))
    # At the flagship, and at L = 287 (attention rows not 16-byte aligned)
    # with H = 16.
    for lo, ho in ((l, h), (287, 16)):
        attn = torch.softmax(rnd(b, ho, lo, lo, scale=2.0), dim=-1)
        pair_o = pair if lo == l else rnd(b, lo, lo, c)
        case('ipa_pair_attend',
             f'attn (4,{ho},{lo},{lo}) f32, pair (4,{lo},{lo},128)',
             ia_op.ipa_pair_attend, ia_op.ipa_pair_attend_plain,
             (attn, pair_o), (attn, pair_o.bfloat16()), [],
             2 * b * ho * lo * lo * c,
             lambda at, pr: torch.einsum('bhij,bijc->bihc', at.to(pr.dtype),
                                         pr),
             one_launch=True, kernel_name='ipa_attend_kernel')
        del attn, pair_o
    # Shapes past one launch's limits (H <= 16; C a multiple of 8, at most
    # 192), which the wrapper cuts into launches of the same kernel: H = 20
    # in two groups of 10 by C = 200 in chunks of 104 and 96 (4 launches),
    # and C = 36 padded to 40 (1 launch).
    for ho, co, n_launch in ((20, 200, 4), (12, 36, 1)):
        attn = torch.softmax(rnd(b, ho, l, l, scale=2.0), dim=-1)
        pair_o = rnd(b, l, l, co)
        case('ipa_pair_attend',
             f'attn (4,{ho},{l},{l}) f32, pair (4,{l},{l},{co}), split',
             ia_op.ipa_pair_attend, ia_op.ipa_pair_attend_plain,
             (attn, pair_o), (attn, pair_o.bfloat16()), [],
             2 * b * ho * l * l * co,
             lambda at, pr: torch.einsum('bhij,bijc->bihc', at.to(pr.dtype),
                                         pr),
             split=('ipa_attend_kernel', n_launch))
        del attn, pair_o

    # Row 13: head-major q / k / v at the tri-attention shape, f32 bias.
    # Its library call is SDPA on (B*R, H, L, D) views with bias + key-mask
    # bias as one additive mask in q's dtype (bf16 here), materialised
    # (B*R, H, L, L) before the timed call: SDPA's mask cannot broadcast
    # one batch element's bias over its rows.
    h, d = 4, 48
    q, k, v = (rnd(b, l, h, l, d) for _ in range(3))
    tbias = rnd(b, h, l, l)
    mb = (1.0 - mask) * -1e9
    sdpa_mask = (tbias + mb[:, None, None, :]).bfloat16()[:, None].expand(
        b, l, h, l, l).reshape(b * l, h, l, l)
    case('triangle_attention_fused', '(4,288,4,288,48), bias f32',
         lambda q, k, v: ta_op.triangle_attention_fused(q, k, v, tbias,
                                                        mask),
         lambda q, k, v: ta_op.triangle_attention_fused_plain(q, k, v, tbias,
                                                              mask),
         (q, k, v), (q.bfloat16(), k.bfloat16(), v.bfloat16()),
         [tbias, mask], 4 * b * l * h * l * l * d,
         lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
             q.flatten(0, 1), k.flatten(0, 1), v.flatten(0, 1),
             attn_mask=sdpa_mask))
    del q, k, v
    # Row 14: ending-node attention on the raw natural pair, C = H*D = 192.
    c = h * d
    x = rnd(b, l, l, c)
    cw = [rnd(c, c, scale=c ** -0.5) for _ in range(4)]
    cols = (1 + rnd(c, scale=0.1), rnd(c, scale=0.1), *cw,
            rnd(c, scale=0.1), tbias)
    cols_pk = {dt: ta_op.pack_projection(*cw[:3], d, dt, ln=cols[:2],
                                         gate=(cw[3], cols[6]))
               for dt in (torch.float32, torch.bfloat16)}
    for flag in ('1', '0'):
        case('triangle_attention_packed_cols',
             f'(4,288,288,192) H=4 D=48, bf16 exp {flag}',
             lambda x: ta_op.triangle_attention_packed_cols(
                 x, *cols, mask, packed=cols_pk[x.dtype]),
             lambda x: ta_op.triangle_attention_packed_cols_plain(
                 x, *cols, mask),
             (x,), (x.bfloat16(),), [*cols, mask],
             2 * m * c * 4 * c + 4 * b * l * h * l * l * d,
             env={'ABX_TRI_ATTN_BF16_EXP': flag},
             plain16=lambda x, f=flag: (
                 ta_op.triangle_attention_packed_cols_plain(
                     x, *cols, mask, bf16_exp=f == '1')))
    del x

    # ESM2-3B attention: head-major views of the (B, L, H, D) projections
    # (strided, as the module hands them in), q pre-scaled; the padded
    # tail of a real complex (29 keys) and one sample padded further.
    b, h, le, d = 4, 40, 306, 64
    q, k, v = ((rnd(b, le, h, d) * (d ** -0.5 if i == 0 else 1.0))
               .transpose(1, 2) for i in range(3))
    pad = torch.zeros(b, le, dtype=torch.bool, device=dev)
    pad[:, -29:] = True
    pad[2, -45:] = True

    def low(t):  # the same strided layout in bf16
        return t.transpose(1, 2).bfloat16().transpose(1, 2)
    case('esm_attention', 'ESM2-3B (4,40,306,64), 29-45 padded keys',
         lambda q, k, v: esm_op.esm_attention(q, k, v, pad),
         lambda q, k, v: esm_op.esm_attention_plain(q, k, v, pad),
         (q, k, v), (low(q), low(k), low(v)), [pad],
         4 * b * h * le * le * d,
         lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
             q, k, v, attn_mask=~pad[:, None, None, :], scale=1.0),
         one_launch=True)
    # The masked-PLL batches (evaluation/pll.py, the eval_pll path, f32):
    # 32 masked copies of a 120-residue chain (L = n + 2) and a last batch
    # of 8 of a 107-residue one; no key padded.
    for pb, pl in ((32, 122), (8, 109)):
        q, k, v = ((rnd(pb, pl, h, d) * (d ** -0.5 if i == 0 else 1.0))
                   .transpose(1, 2) for i in range(3))
        nopad = torch.zeros(pb, pl, dtype=torch.bool, device=dev)
        case('esm_attention', f'masked PLL ({pb},{h},{pl},{d}), no padded '
             'key',
             lambda q, k, v, m=nopad: esm_op.esm_attention(q, k, v, m),
             lambda q, k, v, m=nopad: esm_op.esm_attention_plain(q, k, v, m),
             (q, k, v), (low(q), low(k), low(v)), [nopad],
             4 * pb * h * pl * pl * d,
             lambda q, k, v, m=nopad:
                 torch.nn.functional.scaled_dot_product_attention(
                     q, k, v, attn_mask=~m[:, None, None, :], scale=1.0),
             one_launch=True, time32=True)

    # The flash route (row 15) on the same operands: every row, the padded
    # query rows included (they attend to the padded keys only).  Its
    # library call is SDPA with the segment mask (valid with valid, padded
    # with padded) as a boolean (B, 1, L, L) mask, built before the timed
    # call; it leaves out the stock kernel's zero tail, which only the
    # padded rows see.
    def flash_case(label, q, k, v, m, time32):
        seg = m[:, None, :, None] == m[:, None, None, :]
        case('esm_flash_attention', label,
             lambda q, k, v: esm_op.esm_flash_attention(q, k, v, m),
             lambda q, k, v: esm_op.esm_flash_attention_plain(q, k, v, m),
             (q, k, v), (low(q), low(k), low(v)), [m],
             4 * q.shape[0] * h * q.shape[2] ** 2 * d,
             lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
                 q, k, v, attn_mask=seg, scale=1.0),
             one_launch=True, kernel_name='esm_flash_sm90_kernel',
             time32=time32, share16=True)
    q, k, v = ((rnd(b, le, h, d) * (d ** -0.5 if i == 0 else 1.0))
               .transpose(1, 2) for i in range(3))
    flash_case('ESM2-3B (4,40,306,64), 29-45 padded keys', q, k, v, pad,
               False)
    pb, pl = 32, 122
    q, k, v = ((rnd(pb, pl, h, d) * (d ** -0.5 if i == 0 else 1.0))
               .transpose(1, 2) for i in range(3))
    flash_case(f'masked PLL ({pb},{h},{pl},{d}), no padded key', q, k, v,
               torch.zeros(pb, pl, dtype=torch.bool, device=dev), True)

    # Row 16: ESM2's LayerNorm at the ESM2-3B design batch (B = 16, L =
    # 306: 4,896 rows of 2,560), x with an offset mean as a residual
    # stream has it; weight and bias in x's dtype, as the module holds
    # them, with values exact in bf16 so that both dtypes share them.
    dm = 2560
    x = rnd(16, 306, dm) * 2.0 + 0.5
    lnw = (1 + rnd(dm, scale=0.1)).bfloat16()
    lnb = rnd(dm, scale=0.1).bfloat16()
    ln_wb = {torch.float32: (lnw.float(), lnb.float()),
             torch.bfloat16: (lnw, lnb)}
    case('esm_layer_norm', 'ESM2-3B design batch (16,306,2560), eps 1e-5',
         lambda x: eln_op.esm_layer_norm(x, *ln_wb[x.dtype], 1e-5, x.dtype),
         lambda x: eln_op.esm_layer_norm_plain(x, *ln_wb[x.dtype], 1e-5,
                                               x.dtype),
         (x,), (x.bfloat16(),), [lnw, lnb], 0,
         lambda x: torch.nn.functional.layer_norm(x, (dm,), *ln_wb[x.dtype],
                                                  1e-5),
         one_launch=True, kernel_name='esm_layer_norm_kernel', time32=True,
         share16=True)
    return cases


KERNEL_META = {
    'triangle_attention_packed': (
        'abx_tpu_torch/csrc/tri_attention.cu',
        'abx_tpu/ops/tri_attention.py:226'),
    'pair_bias_proj': ('abx_tpu_torch/csrc/pair_bias.cu',
                       'abx_tpu/ops/pair_bias.py:44'),
    'fused_transition': ('abx_tpu_torch/csrc/transition_sm90.cu',
                         'abx_tpu/ops/transition.py:47'),
    'ipa_attention': ('abx_tpu_torch/csrc/ipa_attention.cu',
                      'abx_tpu/ops/ipa_attention.py:102'),
    'tri_mult_pre': ('abx_tpu_torch/csrc/row_linear.cu',
                     'abx_tpu/ops/tri_mult.py:72'),
    'tri_mult_post': ('abx_tpu_torch/csrc/row_linear.cu',
                      'abx_tpu/ops/tri_mult.py:168'),
    'recycle_embed': ('abx_tpu_torch/csrc/recycle_embed.cu',
                      'abx_tpu/ops/recycle_embed.py:61'),
    'esm_attention': ('abx_tpu_torch/csrc/esm_attention.cu',
                      'abx_tpu/ops/esm_attention.py:47'),
    'esm_flash_attention': ('abx_tpu_torch/csrc/esm_flash_sm90.cu',
                            'abx_tpu/models/esm.py:117'),
    'esm_layer_norm': ('abx_tpu_torch/csrc/esm_layer_norm.cu',
                       'abx_tpu/models/esm.py:215 (XLA fusion, no '
                       'pallas_call)'),
    'tri_mult_pre_no_fgate': ('abx_tpu_torch/csrc/row_linear.cu',
                              'abx_tpu/ops/tri_mult.py:72'),
    'ipa_pair_attend': ('abx_tpu_torch/csrc/ipa_attend.cu',
                        'abx_tpu/ops/ipa_attend.py:36'),
    'triangle_multiply': ('abx_tpu_torch/csrc/triangle.cu',
                          'abx_tpu/ops/triangle.py:81'),
    'tri_mult_post_gatefold': ('abx_tpu_torch/csrc/gatefold_sm90.cu',
                               'abx_tpu/ops/tri_mult.py:245'),
    'gate_proj_residual': ('abx_tpu_torch/csrc/row_linear.cu',
                           'abx_tpu/ops/gate_proj.py:34'),
    'tri_mult_pre_c_major': ('abx_tpu_torch/csrc/row_linear.cu',
                             'abx_tpu/ops/tri_mult.py:72'),
    'tri_mult_post_c_major': ('abx_tpu_torch/csrc/post_cmajor_sm90.cu',
                              'abx_tpu/ops/tri_mult.py:168'),
    'triangle_attention_fused': ('abx_tpu_torch/csrc/tri_attention.cu',
                                 'abx_tpu/ops/tri_attention.py:66'),
    'triangle_attention_packed_cols': ('abx_tpu_torch/csrc/tri_attention.cu',
                                       'abx_tpu/ops/tri_attention.py:422'),
}
FLAGS_TOL = 1e-4   # flags on vs off, relative to max|ref|


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def flash_kernel_report():
    """Row 15's Hopper kernel (csrc/esm_flash_sm90.cu) on this card: CTAs
    an SM, registers and local bytes a thread (the CUDA runtime), and
    ptxas's register and spill lines of each of its instances (build.log
    beside the library)."""
    from abx_tpu_torch.ops import _lib
    from abx_tpu_torch.ops import esm_attention as esm_op
    report = {f'D={d}, L={l}': esm_op.flash_kernel_info(d, l)
              for d, l in ((64, 306), (64, 122), (128, 306))}
    log = _lib.BUILD_ROOT / _lib.source_hash() / 'build.log'
    ptxas, entry = {}, None
    for line in log.read_text().splitlines():
        if 'Compiling entry function' in line:
            name = line.split("'")[1]
            entry = name if 'esm_flash_sm90_kernel' in name else None
        elif entry and ('spill' in line or 'Used' in line):
            ptxas.setdefault(entry, []).append(line.strip())
    report['ptxas'] = ptxas
    for key, val in report.items():
        print(f'kernel esm_flash_attention Hopper kernel {key}: {val}',
              flush=True)
    return report


def phase_kernels(torch, dev):
    results = {'esm_flash_attention': {
        'cases': [], 'hopper_kernel': flash_kernel_report()}}
    for cs in kernel_cases(torch, dev):
        name, label, kern, plain = (cs['name'], cs['label'], cs['kern'],
                                    cs['plain'])
        a32, a16 = cs['a32'], cs['a16']
        saved = {k: os.environ.get(k) for k in cs['env']}
        os.environ.update(cs['env'])
        ref = as_tuple(plain(*a32))
        ref16 = as_tuple(cs['plain16'](*a32)) if cs['plain16'] else ref
        got32 = as_tuple(kern(*a32))
        got16 = as_tuple(kern(*a16))
        torch.cuda.synchronize()
        e32 = e16 = abs16 = 0.0
        for r, r16, g32, g16 in zip(ref, ref16, got32, got16):
            if g32.shape != r.shape or g16.shape != r.shape:
                fail(f'{name} {label}: shape {tuple(g32.shape)} vs '
                     f'{tuple(r.shape)}')
            if not (torch.isfinite(g32).all() and torch.isfinite(g16).all()):
                fail(f'{name} {label}: non-finite output')
            d32, m = rel_err(g32, r)
            d16, m16 = rel_err(g16, r16)
            if d32 > F32_TOL * m or d16 > BF16_TOL * m16:
                fail(f'{name} {label}: f32 err {d32:.3g}, bf16 err '
                     f'{d16:.3g}, max|ref| {m:.3g}')
            e32, e16 = max(e32, d32 / m), max(e16, d16 / m16)
            abs16 = max(abs16, d16)
        shares = None
        if cs['share16']:
            shares = [0.0, 0.0]
            for g16, w16 in zip(got16, as_tuple(plain(*a16))):
                g16, w16 = g16.float(), w16.float()
                # One bf16 step of w16: 2^(e - 8) for |w16| = m 2^e, m in
                # [0.5, 1).
                step = torch.ldexp(torch.ones_like(w16),
                                   torch.frexp(w16).exponent - 8)
                shares[0] = max(shares[0], (g16 != w16).float().mean().item())
                shares[1] = max(shares[1], ((g16 - w16).abs() > step)
                                .float().mean().item())
            print(f'kernel {name} {label}: bf16 against the bf16 plain '
                  f'version: share of outputs that differ {shares[0]:.3g}, '
                  f'more than one bf16 step apart {shares[1]:.3g} (bound '
                  f'{BF16_SHARE})', flush=True)
            if shares[1] > BF16_SHARE:
                fail(f'{name} {label}: {shares[1]:.3g} of the bf16 outputs '
                     'more than one bf16 step from the bf16 plain version')
        nbytes = tensor_bytes([*a16, *cs['reads'], *got16])
        bms, by = bound_ms(cs['flops'], nbytes)
        ms = time_ms(torch, lambda: kern(*a16))
        plain_ms = time_ms(torch, lambda: plain(*a16))
        lib_ms = (time_ms(torch, lambda: cs['library'](*a16))
                  if cs['library'] else None)
        f32 = None
        if cs['time32']:
            nbytes32 = tensor_bytes([*a32, *cs['reads'], *got32])
            bms32, by32 = bound_ms_f32(cs['flops'], nbytes32)
            f32 = {'ms': time_ms(torch, lambda: kern(*a32)),
                   'plain_ms': time_ms(torch, lambda: plain(*a32)),
                   'library_ms': (time_ms(torch, lambda: cs['library'](*a32))
                                  if cs['library'] else None),
                   'bound_ms': bms32, 'bound_by': by32, 'bytes': nbytes32}
        gemm_ms = None
        if cs['gemm']:
            rows = a16[0].numel() // a16[0].shape[-1]
            mats = [(torch.randn(rows, gk, device=dev).bfloat16(),
                     torch.randn(gk, gn, device=dev).bfloat16())
                    for gk, gn in cs['gemm']]
            gemm_ms = time_ms(torch, lambda: [torch.matmul(ga, gb)
                                              for ga, gb in mats])
            del mats
        stream_ms = None
        if cs['stream']:
            stream_ms = time_ms(torch, lambda: cs['stream'][1](*a16))
        launched = dev_ms = None
        if cs['one_launch'] or cs['split']:
            launched, dev_ms = device_kernels(torch, lambda: kern(*a16))
        if cs['one_launch']:
            if launched is not None and len(launched) != 1:
                fail(f'{name} {label}: one call launched {launched}, not '
                     'one kernel')
            want_name = cs['kernel_name']
            if launched is not None and want_name and \
                    want_name not in launched[0]:
                fail(f'{name} {label}: one call launched {launched}, not '
                     f'the kernel {want_name}')
        if cs['split']:
            want_name, n_launch = cs['split']
            ours = [k for k in (launched or []) if want_name in k]
            rest = [k for k in (launched or []) if want_name not in k
                    and 'copy' not in k.lower() and 'fill' not in k.lower()]
            if launched is not None and (len(ours) != n_launch or rest):
                fail(f'{name} {label}: one call launched {launched}, not '
                     f'{n_launch} x {want_name} and layout copies')
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        lib_txt = f', library {lib_ms:.3f} ms' if lib_ms is not None else ''
        if gemm_ms is not None:
            prods = ' + '.join(f'({rows}, {gk}) x ({gk}, {gn})'
                               for gk, gn in cs['gemm'])
            lib_txt += (f'; yardstick torch.matmul {prods} bf16 '
                        f'{gemm_ms:.3f} ms')
        if stream_ms is not None:
            lib_txt += (f'; stream yardstick {cs["stream"][0]} '
                        f'{stream_ms:.3f} ms')
        print(f'kernel {name} {label}: f32 err/max|ref| {e32:.3g}, bf16 '
              f'err/max|ref| {e16:.3g}; bf16 kernel {ms:.3f} ms, plain '
              f'{plain_ms:.3f} ms{lib_txt}; bound {bms:.4f} ms by {by} '
              f'({cs["flops"] / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)',
              flush=True)
        if f32 is not None:
            lib32 = (f', library {f32["library_ms"]:.3f} ms'
                     if f32['library_ms'] is not None else '')
            print(f'kernel {name} {label}: f32 kernel {f32["ms"]:.3f} ms, '
                  f'plain {f32["plain_ms"]:.3f} ms{lib32}; bound '
                  f'{f32["bound_ms"]:.4f} ms by {f32["bound_by"]} (products '
                  f'as bf16x3, {f32["bytes"] / 1e6:.1f} MB)', flush=True)
        entry = results.setdefault(name, {'cases': []})
        entry['cases'].append({
            'case': label, 'max_abs_err': abs16, 'rel_err_bf16': e16,
            'rel_err_f32': e32, 'ms': ms, 'plain_ms': plain_ms,
            'library_ms': lib_ms, 'bound_ms': bms, 'bound_by': by,
            'flops': cs['flops'], 'bytes': nbytes,
            'gemm_yardstick_ms': gemm_ms, 'stream_yardstick_ms': stream_ms})
        if f32 is not None:
            entry['cases'][-1]['f32'] = f32
        if shares is not None:
            entry['cases'][-1]['bf16_share_differing'] = shares[0]
            entry['cases'][-1]['bf16_share_past_one_step'] = shares[1]
        if cs['one_launch'] or cs['split']:
            entry['cases'][-1]['device_kernels_per_call'] = launched
            entry['cases'][-1]['device_ms_per_call'] = dev_ms
            seen = (f'{launched}, {dev_ms:.4f} ms' if launched
                    else 'not recorded by the profiler')
            print(f'kernel {name} {label}: device kernels of one call '
                  f'{seen}', flush=True)
        del ref, ref16, got32, got16
        torch.cuda.empty_cache()
    return results


EXP_TOL = 1e-2   # the core's bf16 exponent vs the final-max plain core


def phase_exponent(torch, dev):
    """The bf16 attention core with the TPU kernel's exponent, exp(bf16(s -
    m)) with m the row's final max, at the tri shape over 16 rows (B=1,
    R=16, L=288, H=4, D=48), rows and columns (R = L = 288, B=1): q (1/4
    steps in [-2, 2]), k (1/8 steps in [-1, 1]) and the bias (1/64 steps
    in [-2, 4], 2 higher on keys >= 64, so each row's max lies past the
    first key tile) make the logits exact in f32 in any order; v is one-hot
    (v[j, e] = [j mod D == e]), so each output is a sum of probabilities.
    Every output must lie within EXP_TOL (relative) of the plain core's on
    the same values; a running max (the core before it took the final
    max) misses that by 4-13x on such rows (tests/test_torch_kernels.py)."""
    from abx_tpu_torch.ops import tri_attention as ta_op
    g = torch.Generator(device=dev).manual_seed(2)
    report = {}
    for columns, (b, r, l, h, d) in ((False, (1, 16, 288, 4, 48)),
                                     (True, (1, 288, 288, 4, 48))):
        n = b * r * l
        idx = torch.arange(n, device=dev)
        pos = (idx // l) % l if columns else idx % l
        q = torch.randint(-8, 9, (n, h * d), generator=g, device=dev) / 4
        k = torch.randint(-8, 9, (n, h * d), generator=g, device=dev) / 8
        v = (pos[:, None] % d == torch.arange(d, device=dev)).float()
        y = torch.cat([q, k, v.repeat(1, h)], 1)
        bias = torch.randint(-128, 129, (b, h, l, l), generator=g,
                             device=dev) / 64
        bias[..., 64:] += 2.0
        kmask = torch.ones(b, l, device=dev)
        kmask[:, 5] = 0.0
        shape = (b, r, l, h, d)
        want = ta_op.tri_attention_core_plain(y, shape, bias, kmask,
                                              False, bf16_exp=True,
                                              columns=columns)
        got = ta_op.tri_attention_core(y.bfloat16(), shape, bias.bfloat16(),
                                       kmask, False, bf16_exp=True,
                                       columns=columns)
        torch.cuda.synchronize()
        if not (want > 0).all():
            fail('exponent check: a plain output is not positive')
        err = ((got.float() - want).abs() / want).max().item()
        what = 'columns' if columns else 'rows'
        print(f'bf16 exponent against the final max, {what} (B={b}, R={r}, '
              f'L={l}, H={h}, D={d}): max rel err {err:.3g} (tolerance '
              f'{EXP_TOL})', flush=True)
        if not err <= EXP_TOL:
            fail(f'the bf16 core missed the final-max exponent ({what}): '
                 f'rel err {err:.3g} > {EXP_TOL}')
        report[what] = err
    return report


# The bf16 rounding-point check: two results at the same rounding points
# differ only where an f32 sum taken in another order lands on the other
# side of a bf16 rounding; one missed rounding point moves 16-29% of the
# outputs (tests/test_torch_kernels.py and tests/test_torch_ops.py).
BF16_SHARE = 1e-2     # share of the bf16 outputs that may differ
BF16_STEPS = 2 ** -7  # max |got - want| / max|want|: two bf16 steps


def phase_rounding_points(torch, dev):
    """The bf16 Hopper kernels of tri_mult_pre (natural, without the final
    gate, channel-major), tri_mult_post (natural and channel-major input),
    the gate-fold post, gate_proj_residual and ipa_pair_attend (f32 attn,
    bf16 pair) against their plain versions in bf16 on the same inputs (the
    TPU kernels' rounding points), at the flagship shapes: at most
    BF16_SHARE of the outputs may differ, by at most BF16_STEPS of
    max|want|; and a second call gives the same bits."""
    from abx_tpu_torch.ops import gate_proj as gp_op
    from abx_tpu_torch.ops import ipa_attend as ia_op
    from abx_tpu_torch.ops import tri_mult as tm_op
    g = torch.Generator(device=dev).manual_seed(4)
    b, l, c, nc = 4, 288, 192, 128

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def bf(*shape, scale=1.0):
        return rnd(*shape, scale=scale).bfloat16()
    mask = torch.ones(b, l, device=dev)
    mask[:, -9:] = 0.0
    x, res = bf(b, l, l, c), bf(b, l, l, c)
    lnp = (1 + rnd(c, scale=0.1), rnd(c, scale=0.1))
    w_pre, b_pre = rnd(4 * nc + c, c, scale=c ** -0.5), rnd(4 * nc + c,
                                                            scale=0.5)
    parts = (torch.split(w_pre, [nc] * 4 + [c]),
             torch.split(b_pre, [nc] * 4 + [c]))
    pre = (*lnp, w_pre, b_pre, mask)
    pre4 = (*lnp, w_pre[:4 * nc], b_pre[:4 * nc], mask)
    pk = tm_op.pack_pre(*parts, *lnp, torch.bfloat16)
    pk4 = tm_op.pack_pre(parts[0][:4], parts[1][:4], *lnp, torch.bfloat16)
    y, fg = bf(b, l, l, nc), bf(b, l, l, c)
    post = (1 + rnd(nc, scale=0.1), rnd(nc, scale=0.1),
            rnd(c, nc, scale=nc ** -0.5), rnd(c, scale=0.1))
    fold = (*lnp, rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.5))
    fold_pk = tm_op.pack_gatefold(*post, *fold, torch.bfloat16)
    gy, gate = bf(b, l, l, c), bf(b, l, l, c, scale=2.0)
    gw = (rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1))
    ycm = bf(b, nc, l, l)
    post_pk = tm_op.pack_post(*post, torch.bfloat16)
    attn = torch.softmax(rnd(b, 12, l, l, scale=2.0), dim=-1)
    pair = bf(b, l, l, 128)
    # ipa_pair_attend at shapes the wrapper splits into several launches.
    attn20 = torch.softmax(rnd(b, 20, l, l, scale=2.0), dim=-1)
    pair200, pair36 = bf(b, l, l, 200), bf(b, l, l, 36)
    cases = [
        ('tri_mult_pre', lambda: tm_op.tri_mult_pre(x, *pre, packed=pk),
         lambda: tm_op.tri_mult_pre_plain(x, *pre)),
        ('tri_mult_pre_no_fgate',
         lambda: tm_op.tri_mult_pre(x, *pre4, emit_fgate=False, packed=pk4),
         lambda: tm_op.tri_mult_pre_plain(x, *pre4, emit_fgate=False)),
        ('tri_mult_pre_c_major',
         lambda: tm_op.tri_mult_pre(x, *pre, c_major=True, packed=pk),
         lambda: tm_op.tri_mult_pre_plain(x, *pre, c_major=True)),
        ('tri_mult_post', lambda: tm_op.tri_mult_post(y, *post, fg, res),
         lambda: tm_op.tri_mult_post_plain(y, *post, fg, res)),
        ('tri_mult_post_gatefold',
         lambda: tm_op.tri_mult_post_gatefold(y, *post, *fold, res,
                                              packed=fold_pk),
         lambda: tm_op.tri_mult_post_gatefold_plain(y, *post, *fold, res)),
        ('gate_proj_residual',
         lambda: gp_op.gate_proj_residual(gy, gate, *gw, res),
         lambda: gp_op.gate_proj_residual_plain(gy, gate, *gw, res)),
        ('tri_mult_post_c_major',
         lambda: tm_op.tri_mult_post(ycm, *post, fg, res, y_c_major=True,
                                     packed=post_pk),
         lambda: tm_op.tri_mult_post_plain(ycm, *post, fg, res,
                                           y_c_major=True)),
        ('ipa_pair_attend', lambda: ia_op.ipa_pair_attend(attn, pair),
         lambda: ia_op.ipa_pair_attend_plain(attn, pair)),
        ('ipa_pair_attend H=20 C=200',
         lambda: ia_op.ipa_pair_attend(attn20, pair200),
         lambda: ia_op.ipa_pair_attend_plain(attn20, pair200)),
        ('ipa_pair_attend H=12 C=36',
         lambda: ia_op.ipa_pair_attend(attn, pair36),
         lambda: ia_op.ipa_pair_attend_plain(attn, pair36))]
    report = {}
    for name, kern, plain in cases:
        want = as_tuple(plain())
        got, again = as_tuple(kern()), as_tuple(kern())
        torch.cuda.synchronize()
        worst = (0.0, 0.0)
        for gt, ag, wt in zip(got, again, want):
            if not torch.equal(gt, ag):
                fail(f'rounding points, {name}: a second call gave other '
                     'bits')
            err = ((gt.float() - wt.float()).abs().max()
                   / wt.float().abs().max()).item()
            share = (gt != wt).float().mean().item()
            worst = (max(worst[0], err), max(worst[1], share))
        print(f'rounding points, {name} bf16 (4,288,288): max err/max|want| '
              f'{worst[0]:.3g} (bound {BF16_STEPS:.3g}), share of outputs '
              f'that differ {worst[1]:.3g} (bound {BF16_SHARE})', flush=True)
        if not (worst[0] <= BF16_STEPS and worst[1] <= BF16_SHARE):
            fail(f'{name} missed the bf16 plain version\'s rounding points: '
                 f'err {worst[0]:.3g}, share {worst[1]:.3g}')
        report[name] = {'rel_err': worst[0], 'share_differing': worst[1]}
        del want, got, again
    torch.cuda.empty_cache()
    return report


def phase_one_tile(torch, dev):
    """The channel-major post's Hopper kernel on one 64-position tile (B=1,
    R = L = 8, nc = 128, C = 192), bf16, against the bf16 plain version at
    the rounding-point bars: the MN-major wgmma descriptor of its
    transposed A operand (the stride of its 8-channel groups) is held here
    before any timed run."""
    from abx_tpu_torch.ops import tri_mult as tm_op
    g = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    nc, c = 128, 192
    y, fg, res = (rnd(1, nc, 8, 8).bfloat16(), rnd(1, 8, 8, c).bfloat16(),
                  rnd(1, 8, 8, c).bfloat16())
    post = (1 + rnd(nc, scale=0.1), rnd(nc, scale=0.1),
            rnd(c, nc, scale=nc ** -0.5), rnd(c, scale=0.1))
    if not tm_op.post_c_major_hopper_route(y, res):
        fail('one-tile check: the case does not take the Hopper kernel')
    got = tm_op.tri_mult_post(y, *post, fg, res, y_c_major=True)
    want = tm_op.tri_mult_post_plain(y, *post, fg, res, y_c_major=True)
    torch.cuda.synchronize()
    err = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    share = (got != want).float().mean().item()
    print(f'one-tile check of the MN-major wgmma descriptor '
          f'(tri_mult_post_c_major, (1,128,8,8) -> 192, bf16): max '
          f'err/max|want| {err:.3g} (bound {BF16_STEPS:.3g}), share of outputs '
          f'that differ {share:.3g} (bound {BF16_SHARE})', flush=True)
    if not (err <= BF16_STEPS and share <= BF16_SHARE):
        fail(f'one-tile check: the MN-major descriptor is wrong: err '
             f'{err:.3g}, share {share:.3g}')
    return {'rel_err': err, 'share_differing': share}


IPA_CANCEL_TOL = 1e-2   # the IPA scalar attend vs the bf16-p plain version


def phase_ipa_cancel(torch, dev):
    """The bf16 IPA scalar attend with p rounded to bf16, as the TPU kernel
    does (p.astype(in_dt) before the dot): B=4, L=288, H=12, C=128; every
    query row of head h puts nearly all its weight on keys 0 and 1 (bias 4
    and 4 - gap_h, the other keys -30, no scalar or point term), whose
    values are +1 and -1, so each out_s element is p_0 - p_1 and moves by
    15-35% with the rounding of p (the gaps keep p_0 and p_1 at least 0.2
    bf16 ulp from a rounding midpoint).  out_s must lie within
    IPA_CANCEL_TOL (relative) of the bf16-p plain version; an f32-p
    scalar attend misses it (tests/test_torch_kernels.py)."""
    from abx_tpu_torch.ops import ipa_attention as ipa_op
    b, l, h, ds, c = 4, 288, 12, 16, 128
    gaps = torch.tensor([0.0132816, 0.0179590, 0.0133092] * 4, device=dev)
    qs = torch.zeros(b, l, h, ds, device=dev).bfloat16()
    vs = torch.zeros(b, l, h, ds, device=dev)
    vs[:, 0], vs[:, 1] = 1.0, -1.0
    pts = [torch.zeros(b, l, h, p, 3, device=dev) for p in (4, 4, 8)]
    bias = torch.full((b, h, l, l), -30.0, device=dev)
    bias[..., 0] = 4.0
    bias[..., 1] = (4.0 - gaps)[None, :, None]
    pair = torch.randn(b, l, l, c, generator=torch.Generator(
        device=dev).manual_seed(3), device=dev).bfloat16()
    args = (qs, qs, vs.bfloat16(), *pts, torch.full((h,), -0.1, device=dev),
            bias, torch.ones(b, l, device=dev), pair)
    want = ipa_op.ipa_attention_plain(*args)[0].float()
    got = ipa_op.ipa_attention(*args)[0].float()
    probs = torch.softmax(bias, dim=-1)
    f32_p = torch.einsum('bhij,bjhd->bihd', probs, vs).reshape(
        b, l, h * ds).bfloat16().float()
    torch.cuda.synchronize()
    if not (want.abs() > 0).all():
        fail('IPA cancellation check: a plain output is 0')
    err = ((got - want).abs() / want.abs()).max().item()
    err_f32p = ((f32_p - want).abs() / want.abs()).max().item()
    print(f'ipa_attention scalar attend, bf16 p (B={b}, L={l}, H={h}): max '
          f'rel err {err:.3g} against the bf16-p plain version (tolerance '
          f'{IPA_CANCEL_TOL}); an f32-p attend: {err_f32p:.3g}', flush=True)
    if not err <= IPA_CANCEL_TOL:
        fail(f'the IPA scalar attend missed the bf16-p plain version: rel '
             f'err {err:.3g} > {IPA_CANCEL_TOL}')
    return {'max_rel_err': err, 'f32_p_emulation_rel_err': err_f32p}


def device_kernels(torch, fn):
    """(names, summed device ms) of the device kernels one fn() call
    launches, from torch.profiler ((None, None) when the profiler records
    no device activity)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ev:
        return None, None
    return ([e.name for e in ev],
            sum(e.time_range.elapsed_us() for e in ev) / 1e3)


def device_kernel_names(torch, fn):
    """Names of the device kernels fn() launches (None when the profiler
    records no device activity)."""
    return device_kernels(torch, fn)[0]


def phase_contraction(torch, dev):
    """The triangle contraction at (4,288,288,128) bf16, both orientations:
    the channel-major batched matrix product of the ABX_TRIMULT_C_MAJOR
    route (on (4,128,288,288) operands), the natural-layout einsum and the
    triangle_multiply kernel, timed in one call; the channel-major product
    must launch no copy kernel."""
    from abx_tpu_torch.ops import triangle as tg_op
    g = torch.Generator(device=dev).manual_seed(1)
    left, right = (torch.randn((4, 288, 288, 128), generator=g, device=dev)
                   .bfloat16() for _ in range(2))
    lc, rc = (t.permute(0, 3, 1, 2).contiguous() for t in (left, right))
    report = {}
    for per_row in (True, False):
        orient = 'per_row' if per_row else 'per_column'

        def c_major():
            return tg_op.triangle_multiply_c_major(lc, rc, per_row)
        want = tg_op.triangle_multiply_einsum(left.float(), right.float(),
                                              per_row)
        d, m = rel_err(c_major().permute(0, 2, 3, 1), want)
        if d > BF16_TOL * m:
            fail(f'c-major contraction {orient}: err {d:.3g}, max|ref| '
                 f'{m:.3g}')
        names = device_kernel_names(torch, c_major)
        copies = [n for n in names or []
                  if 'copy' in n.lower() or 'elementwise' in n.lower()]
        if copies:
            fail(f'c-major contraction {orient} launched copy kernels: '
                 f'{copies}')
        times = {'c_major_matmul_ms': time_ms(torch, c_major),
                 'natural_einsum_ms': time_ms(
                     torch, lambda: tg_op.triangle_multiply_einsum(
                         left, right, per_row)),
                 'kernel_ms': time_ms(
                     torch, lambda: tg_op.triangle_multiply_kernel(
                         left, right, per_row))}
        report[orient] = {**times, 'device_kernels': names,
                          'rel_err_bf16': d / m}
        print(f'contraction {orient} (4,288,288,128) bf16: c-major matmul '
              f'{times["c_major_matmul_ms"]:.3f} ms, natural einsum '
              f'{times["natural_einsum_ms"]:.3f} ms, triangle_multiply '
              f'kernel {times["kernel_ms"]:.3f} ms; c-major device kernels '
              f'{names if names else "not recorded by the profiler"}',
              flush=True)
    del left, right, lc, rc
    torch.cuda.empty_cache()
    return report


# The eight default-on kernel flags, and the opt-in kernel configuration:
# the JAX package's opt-in kernel flags with the triangle-attention LN-fold
# off (the route on which the gate_proj kernel applies).
DEFAULT_FLAGS = ['ABX_FUSED_TRI_ATTN', 'ABX_TRI_ATTN_LN_FOLD',
                 'ABX_PACKED_SEQ_ATTN', 'ABX_FUSED_PAIR_BIAS',
                 'ABX_FUSED_TRANSITION', 'ABX_FUSED_IPA_ATTN',
                 'ABX_FUSED_TRIMULT', 'ABX_FUSED_RECYCLE']
OPT_IN = {'ABX_FUSED_IPA_ATTN': '0', 'ABX_IPA_ATTEND': '1',
          'ABX_PALLAS_TRIANGLE': '1', 'ABX_TRIMULT_GATEFOLD': '1',
          'ABX_TRI_ATTN_LN_FOLD': '0', 'ABX_GATE_PROJ_KERNEL': '1'}
C_MAJOR = {**{k: '1' for k in DEFAULT_FLAGS}, 'ABX_TRIMULT_C_MAJOR': '1'}
ALL_FLAGS = DEFAULT_FLAGS + [k for k in [*OPT_IN, *C_MAJOR]
                             if k not in DEFAULT_FLAGS]


def set_flags(env):
    """Set the kernel flags to `env` (unlisted ones removed)."""
    for k in ALL_FLAGS:
        os.environ.pop(k, None)
    os.environ.update(env)


def phase_flags(torch, dev):
    """Phases 4, 4c and 4d: one full-width f32 forward_with_recycling with
    every kernel flag off, each of whose passes is then run again, on the
    same inputs, with the default flags, in the opt-in configuration and
    with the default flags under ABX_TRIMULT_C_MAJOR=1.

    The recycled inputs are step functions of the previous pass (the
    distogram bins of its positions, the argmax of its logits): a 1e-6
    difference flips the bin of a pair that sits on an edge and the next
    pass then differs by O(1) there, whatever the precision.  So every pass
    of the two kernel routes is fed the recycled inputs of the flags-off
    run and held to that run's pass."""
    import numpy as np
    from abx_tpu_torch.cli import runner
    from abx_tpu_torch.geometry import quat as quat_ops
    from abx_tpu_torch.models.network import forward_with_recycling, zero_prev
    from abx_tpu_torch.sampling.sampler import Sampler, SamplerConfig
    from abx_tpu_torch.sampling.sampler import to_device_batch
    from abx_tpu_torch.utils import params as params_lib
    rt = runner.build_runtime(MODEL_CONFIG, seed=0, device=dev.type)
    cfg, diffuser, model = rt.config, rt.diffuser, rt.model
    # Dense random weights: AF2's zero 'final' inits would hide layers from
    # the comparison.
    params_lib.load_flax_params(model, params_lib.dense_random_tree(
        params_lib.state_dict_tree(model), seed=0, scale=0.5))
    feats, _ = next(runner.load_complexes(None, None, PDB, rt))
    batch = {k: np.stack([v] * 4) for k, v in feats.items()}
    sampler = Sampler(model, diffuser, cfg.model, SamplerConfig(num_t=8))
    prepared = sampler.prepare(to_device_batch(batch, dev),
                               torch.Generator(device=dev).manual_seed(0))
    b, l = prepared['seq'].shape
    t_vec = torch.full((b,), 0.6, device=dev)
    rot_s, trans_s = diffuser.score_scaling(t_vec)
    prepared.update(t=t_vec, rot_score_scaling=rot_s,
                    trans_score_scaling=trans_s)
    prepared.update(zero_prev(b, l, cfg.model, device=dev))
    prepared = {k: v for k, v in prepared.items() if torch.is_tensor(v)}
    static = model.static_embeddings(prepared)

    def one_pass(mb):
        # The kernels have no backward: a call with grad enabled on the
        # model's parameters is refused by the wrappers.
        with torch.no_grad():
            out = model(mb, static_acts=static)
        torch.cuda.synchronize()
        return out

    def picked(out):
        return {'rot_score': out['heads']['folding']['rot_score'],
                'trans_score': out['heads']['folding']['trans_score'],
                'logits': out['heads']['sequence_module']['logits'],
                'rigids': out['heads']['folding']['rigids']}

    set_flags({k: '0' for k in ALL_FLAGS})
    inputs, ref = [], []

    def recorded(mb, compute_loss=False):
        inputs.append(dict(mb))
        out = one_pass(mb)
        ref.append(picked(out))
        return out
    forward_with_recycling(recorded, prepared, cfg.model.num_recycle,
                           cfg.model.embeddings_and_seqformer.prev_pos)
    valid = prepared['mask'] > 0

    def omega_bin(rigids):
        """The IGSO(3) table bin of the rotation whose score is rot_score
        (SO3Diffuser.score, as IpaScore calls it)."""
        q = quat_ops.quat_multiply(quat_ops.invert_quat(rigids[..., :4]),
                                   prepared['rigids_t'][..., :4].float())
        omega = torch.linalg.norm(quat_ops.quat_to_rotvec(q), dim=-1) + 1e-6
        grid = diffuser.so3.discrete_omega[:-1].contiguous()
        return torch.searchsorted(grid, omega.contiguous())

    # rot_score is piecewise constant in the rotation angle (a table of
    # 1000 bins): where a residue's angle crosses a bin edge between two
    # runs, its score jumps by the table's step (~1e-3), whatever the
    # precision.  It is held on the residues whose bin is the same in both
    # runs, and the crossings are counted; the predicted rigids, which
    # rot_score is a function of, are held everywhere.
    report, errors = {}, []
    for name, env in (('on', {k: '1' for k in DEFAULT_FLAGS}),
                      ('opt_in', OPT_IN), ('c_major', C_MAJOR)):
        set_flags(env)
        worst, crossed_n, crossed_d = {}, 0, 0.0
        for p, mb in enumerate(inputs):
            got, want = picked(one_pass(mb)), ref[p]
            same_bin = omega_bin(got['rigids']) == omega_bin(want['rigids'])
            crossed = valid & ~same_bin
            crossed_n += int(crossed.sum())
            if crossed.any():
                crossed_d = max(crossed_d, rel_err(
                    got['rot_score'][crossed], want['rot_score'][crossed])[0])
            for key in want:
                rows = valid & same_bin if key == 'rot_score' else valid
                g, w = got[key][rows], want[key][rows]
                if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
                    errors.append(f'flags {name} vs off: non-finite {key}')
                d, m = rel_err(g, w)
                if key not in worst or d / m > worst[key][0] / worst[key][1]:
                    worst[key] = (d, m)
        for key, (d, m) in worst.items():
            report.setdefault(name, {})[key] = {'max_abs_err': d,
                                                'max_abs_ref': m}
            print(f'flags {name} vs off (f32, full width, {len(inputs)} '
                  f'passes on the same inputs, valid rows) {key}: max '
                  f'|diff| {d:.3g}, max|ref| {m:.3g}', flush=True)
            if d > FLAGS_TOL * m:
                errors.append(f'flags {name} vs off: {key} differs by '
                              f'{d:.3g} (max|ref| {m:.3g})')
        report[name]['rot_score_bin_crossings'] = {
            'residues': crossed_n, 'of': int(valid.sum()) * len(inputs),
            'max_abs_diff': crossed_d}
        print(f'flags {name} vs off: {crossed_n} of '
              f'{int(valid.sum()) * len(inputs)} valid residue-passes crossed '
              f'an angle bin edge (rot_score max |diff| there '
              f'{crossed_d:.3g})', flush=True)
    set_flags({})
    if errors:
        fail('; '.join(errors))
    del rt, model, inputs, ref
    torch.cuda.empty_cache()
    return report


def check_pdb(path, want=('H', 'L', 'S')):
    chains, coords = set(), []
    with open(path) as f:
        for line in f:
            if line.startswith('ATOM'):
                chains.add(line[21])
                coords.append([float(line[30:38]), float(line[38:46]),
                               float(line[46:54])])
    if chains != set(want):
        fail(f'{path}: chains {sorted(chains)}, expected {sorted(want)}')
    import math
    if not coords or not all(math.isfinite(v) for c in coords for v in c):
        fail(f'{path}: empty or non-finite coordinates')


def dense_esm(torch, dev):
    """ESM2-3B's AntibodyESM with dense random weights made on `dev` from
    seed 0, and the 6ct7 antibody as four noisy sequences (three with
    re-drawn residues) with learned-layer weights: (esm, (ab, hl, ll, lw),
    l_ab)."""
    import numpy as np
    from abx_tpu_torch import config as config_lib
    from abx_tpu_torch.data import dataset as ds
    from abx_tpu_torch.models.esm import AntibodyESM, ESM2Config
    cfg = config_lib.load_config(MODEL_CONFIG)
    l_ab = cfg.data.max_antibody_len
    esm = AntibodyESM(ESM2Config.t36_3B(), l_ab, dtype=torch.float32,
                      device='meta').to_empty(device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        # Dense weights give O(1) attention logits: kernels N(0, 1/fan_in),
        # LayerNorm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2).
        for key, p in esm.named_parameters():
            p.normal_(0.0, 1.0, generator=g)
            if p.ndim == 2 and 'embed_tokens' not in key:
                p.mul_(p.shape[1] ** -0.5)
            elif p.ndim == 1:
                p.mul_(0.1)
                if key.endswith('norm.weight') or 'norm_after.weight' in key:
                    p.add_(1.0)
    esm.requires_grad_(False).eval()
    ex = ds.complex_from_pdb(PDB, 'H', 'L', ['S'])
    feats, _ = ds.prepare_example(ex, ds.DataConfig(
        l_ab, cfg.data.max_antigen_len, cfg.data.patch_radius,
        cfg.data.anchor_neighbors), False)
    ab = torch.tensor(np.stack([feats['seq'][:l_ab]] * 4), device=dev)
    redraw = torch.rand(ab.shape, generator=g, device=dev) < 0.3
    redraw[0] = False
    ab = torch.where(redraw, torch.randint(0, 20, ab.shape, generator=g,
                                           device=dev), ab)
    hl = torch.tensor([int(feats['heavy_len'])] * 4, device=dev)
    ll = torch.tensor([int(feats['light_len'])] * 4, device=dev)
    lw = torch.softmax(torch.randn(37, generator=g, device=dev), dim=0)
    return esm, (ab, hl, ll, lw), l_ab


ESM_ROUTES = {'on': {'ABX_FUSED_ESM_ATTN': '1'},
              'off': {'ABX_FUSED_ESM_ATTN': '0'},
              'flash': {'ABX_FUSED_ESM_ATTN': '0', 'ABX_FLASH_ESM': '1'}}


def phase_esm_flags(torch, dev):
    """Full-width f32 ESM2-3B forward of AntibodyESM on the 6ct7 antibody
    (four samples, three with re-drawn residues, as noisy sequences), dense
    random weights made on the card, with the ESM attention kernel on, off
    (plain f32 version) and on the flash route (its segment-masked
    kernel), each held to off on the valid rows."""
    esm, (ab, hl, ll, lw), l_ab = dense_esm(torch, dev)
    outs = {}
    for route, env in ESM_ROUTES.items():
        os.environ.update(env)
        with torch.no_grad():
            outs[route] = esm(ab, hl, ll, lw)
        torch.cuda.synchronize()
        for k in env:
            os.environ.pop(k)
    valid = torch.arange(l_ab, device=dev)[None] < (hl + ll)[:, None]
    off = outs['off'][valid]
    report = {}
    for route in ('on', 'flash'):
        on = outs[route][valid]
        if not (torch.isfinite(on).all() and torch.isfinite(off).all()):
            fail(f'ESM flags {route} vs off: non-finite weighted embedding')
        d, m = rel_err(on, off)
        print(f'ESM flags {route} vs off (f32 ESM2-3B, weighted embedding, '
              f'valid rows): max |diff| {d:.3g}, max|ref| {m:.3g}',
              flush=True)
        if d > FLAGS_TOL * m:
            fail(f'ESM flags {route} vs off: weighted embedding differs by '
                 f'{d:.3g} (max|ref| {m:.3g})')
        report[route] = {'max_abs_err': d, 'max_abs_ref': m}
    del esm, outs, on, off
    torch.cuda.empty_cache()
    return {**report['on'], 'flash': report['flash']}


def wrappers():
    from abx_tpu_torch.ops import esm_attention as esm_op
    from abx_tpu_torch.ops import esm_layer_norm as eln_op
    from abx_tpu_torch.ops import gate_proj as gp_op
    from abx_tpu_torch.ops import ipa_attend as ia_op
    from abx_tpu_torch.ops import ipa_attention as ipa_op
    from abx_tpu_torch.ops import pair_bias as pb_op
    from abx_tpu_torch.ops import recycle_embed as re_op
    from abx_tpu_torch.ops import transition as tr_op
    from abx_tpu_torch.ops import tri_attention as ta_op
    from abx_tpu_torch.ops import tri_mult as tm_op
    from abx_tpu_torch.ops import triangle as tg_op
    return {'triangle_attention_packed': ta_op.triangle_attention_packed,
            'triangle_attention_fused': ta_op.triangle_attention_fused,
            'triangle_attention_packed_cols':
                ta_op.triangle_attention_packed_cols,
            'pair_bias_proj': pb_op.pair_bias_proj,
            'fused_transition': tr_op.fused_transition,
            'ipa_attention': ipa_op.ipa_attention,
            'tri_mult_pre': tm_op.tri_mult_pre,
            'tri_mult_post': tm_op.tri_mult_post,
            'recycle_embed': re_op.recycle_embed,
            'esm_attention': esm_op.esm_attention,
            'esm_flash_attention': esm_op.esm_flash_attention,
            'esm_layer_norm': eln_op.esm_layer_norm,
            'ipa_pair_attend': ia_op.ipa_pair_attend,
            'triangle_multiply': tg_op.triangle_multiply_kernel,
            'tri_mult_post_gatefold': tm_op.tri_mult_post_gatefold,
            'gate_proj_residual': gp_op.gate_proj_residual}


def reset_counts(ws):
    for w in ws.values():
        w.launches = 0
    ws['tri_mult_pre'].launches_no_fgate = 0
    ws['tri_mult_pre'].launches_c_major = 0
    ws['tri_mult_post'].launches_c_major = 0


def read_counts(ws):
    """Launches per kernel; the variants of tri_mult_pre (without the final
    gate, channel-major) and tri_mult_post (channel-major) apart."""
    counts = {k: w.launches for k, w in ws.items()}
    counts['tri_mult_pre_no_fgate'] = ws['tri_mult_pre'].launches_no_fgate
    counts['tri_mult_pre_c_major'] = ws['tri_mult_pre'].launches_c_major
    counts['tri_mult_post_c_major'] = ws['tri_mult_post'].launches_c_major
    counts['tri_mult_pre'] -= (counts['tri_mult_pre_no_fgate']
                               + counts['tri_mult_pre_c_major'])
    counts['tri_mult_post'] -= counts['tri_mult_post_c_major']
    return counts


NUM_T, NUM_SAMPLES, NUM_RECYCLE, ESM_LAYERS = 8, 4, 2, 36
PASSES = (NUM_T + 1) * (NUM_RECYCLE + 1)     # prime step + num_t steps
PER_PASS = {'triangle_attention_packed': 3, 'pair_bias_proj': 3,
            'fused_transition': 1, 'ipa_attention': 8, 'tri_mult_pre': 2,
            'tri_mult_post': 2, 'recycle_embed': 1}
# The opt-in configuration, per trunk pass: tri start and end without the
# LN-fold (their bias in torch) plus the seq attention; the pair bias of the
# seq attention only; the IPA attends in the non-fused route of 8 layers;
# the gate-fold triangle multiplications with the contraction kernel; the
# gate_proj epilogue of both triangle attentions.
OPT_PER_PASS = {'triangle_attention_packed': 3, 'pair_bias_proj': 1,
                'fused_transition': 1, 'ipa_pair_attend': 8,
                'tri_mult_pre_no_fgate': 2, 'tri_mult_post_gatefold': 2,
                'triangle_multiply': 2, 'gate_proj_residual': 2,
                'recycle_embed': 1}
# ABX_TRIMULT_C_MAJOR=1 at the default flags: both triangle
# multiplications take the channel-major pre and post.
C_MAJOR_PER_PASS = {**{k: n for k, n in PER_PASS.items()
                       if k not in ('tri_mult_pre', 'tri_mult_post')},
                    'tri_mult_pre_c_major': 2, 'tri_mult_post_c_major': 2}
OPT_STEP, TRAJ_NUM_T = 4, 3


def esm_ln_launches(layers, forwards, heads=0):
    """esm_layer_norm's launches in `forwards` eval-mode forwards of an ESM2
    of `layers` layers (two LayerNorms a layer and the final one) and
    `heads` masked-LM head calls (one each).  In training the Trainer puts
    the frozen ESM2 in train mode, whose two-pass LayerNorms launch none."""
    return (2 * layers + 1) * forwards + heads


def check_launches(launches, expected, what):
    for name, n in launches.items():
        if n != expected.get(name, 0):
            fail(f'{name}: {n} launches on the {what} path, expected '
                 f'{expected.get(name, 0)}')
    print(f'launches on the {what} path: {json.dumps(launches)}', flush=True)


def check_design(out, launches, expected, what):
    for i in range(NUM_SAMPLES):
        path = os.path.join(out, 'design', f'{i:04d}', '6ct7_H_L_S.pdb')
        if not os.path.exists(path):
            fail(f'{what} wrote no {path}')
        check_pdb(path)
    check_pdb(os.path.join(out, 'design', 'reference', '6ct7_H_L_S.pdb'))
    check_launches(launches, expected, what)


def design_stats(log, wall, card, what):
    if not log:
        fail(f'{what} returned no sampling record')
    sampling_s = sum(e for _, _, e in log)
    per_step = sampling_s / (NUM_T + 1)
    sph = NUM_SAMPLES / sampling_s * 3600.0
    wall_txt = f'wall {wall:.2f} s incl. model build, ' if wall else ''
    print(f'{what} (bf16, B=4, L=288, num_recycle 2, num_t {NUM_T}) on '
          f'{card}: {wall_txt}sampling '
          f'{sampling_s:.2f} s, {per_step:.3f} s per diffusion step '
          f'({NUM_T} steps + prime), {sph:.1f} samples/hour at num_t '
          f'{NUM_T}', flush=True)
    return {'wall_s': wall, 'sampling_s': sampling_s, 's_per_step': per_step,
            'samples_per_hour': sph}


def phase_design(torch, card, env=None, per_pass=PER_PASS, what='design',
                 keep=None):
    """The ESM-off design path, through the design CLI, with the kernel
    flags `env` (phase 8: ABX_TRIMULT_C_MAJOR=1); its output directory is
    `keep` where given (phase 11 evaluates phase 5's designs)."""
    from abx_tpu_torch.cli import design
    ws = wrappers()
    expected = {k: n * PASSES for k, n in per_pass.items()}
    with tempfile.TemporaryDirectory() as tmp:
        out = keep or tmp
        argv = ['--pdb_file', PDB, '--output_dir', out, '--model_config',
                MODEL_CONFIG, '--seed', '0', '--bf16', '--device', 'cuda',
                '--num_samples', str(NUM_SAMPLES), '--batch_samples',
                str(NUM_SAMPLES), '--num_t', str(NUM_T)]
        set_flags(env or {})
        reset_counts(ws)
        t0 = time.time()
        log = design.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_counts(ws)
        set_flags({})
        check_design(out, launches, expected, what)
    return launches, design_stats(log, wall, card, what)


def phase_design_esm(torch, card):
    """The ESM2-3B-conditioned design path, through the runner API (ESM2
    with random weights made on the card), then a second trajectory in the
    same process for the steady-state step."""
    from abx_tpu_torch.cli import runner
    ws = wrappers()
    expected = {k: n * PASSES for k, n in PER_PASS.items()}
    expected['esm_attention'] = ESM_LAYERS * PASSES
    expected['esm_layer_norm'] = esm_ln_launches(ESM_LAYERS, PASSES)
    with tempfile.TemporaryDirectory() as out:
        reset_counts(ws)
        t0 = time.time()
        rt = runner.build_runtime(MODEL_CONFIG, seed=0, bf16=True,
                                  device='cuda', esm_random=True)
        complexes = list(runner.load_complexes(None, None, PDB, rt))
        log = runner.run_sampling(
            rt, os.path.join(out, 'design'), complexes,
            num_samples=NUM_SAMPLES, num_t=NUM_T, seed=0,
            batch_samples=NUM_SAMPLES)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_counts(ws)
        check_design(out, launches, expected, 'ESM-on design')
        stats = design_stats(log, wall, card, 'ESM-on design')
        log2 = runner.run_sampling(
            rt, os.path.join(out, 'again'), complexes,
            num_samples=NUM_SAMPLES, num_t=NUM_T, seed=1,
            batch_samples=NUM_SAMPLES)
        torch.cuda.synchronize()
    steady = design_stats(log2, None, card, 'ESM-on design, second '
                          'trajectory')
    stats['steady_s_per_step'] = steady['s_per_step']
    stats['steady_samples_per_hour'] = steady['samples_per_hour']
    return launches, stats, rt, complexes


# Phase 6b: ESM reuse across the recycle passes, the embedding refreshed at
# every REFRESH-th grid position (the prime step is position 0), and
# CORRECTOR Gibbs-corrector jumps a step.
REFRESH, CORRECTOR = 2, 2


def phase_design_esm_reuse(torch, card, rt, complexes):
    """Phase 6b: the ESM-on design of phase 6 on its runtime with the
    sampler's opt-in ESM reuse and corrector, through the runner API."""
    from abx_tpu_torch.cli import runner
    ws = wrappers()
    refreshes = len(range(0, NUM_T + 1, REFRESH))
    expected = {k: n * PASSES for k, n in PER_PASS.items()}
    expected['esm_attention'] = ESM_LAYERS * refreshes
    expected['esm_layer_norm'] = esm_ln_launches(ESM_LAYERS, refreshes)
    with tempfile.TemporaryDirectory() as out:
        reset_counts(ws)
        log = runner.run_sampling(
            rt, os.path.join(out, 'design'), complexes,
            num_samples=NUM_SAMPLES, num_t=NUM_T, seed=0,
            batch_samples=NUM_SAMPLES, esm_reuse_recycles=True,
            esm_refresh_every=REFRESH, seq_corrector_steps=CORRECTOR)
        torch.cuda.synchronize()
        launches = read_counts(ws)
        check_design(out, launches, expected,
                     f'ESM-on design, ESM reuse (refresh every {REFRESH}, '
                     f'{CORRECTOR} corrector steps)')
    return launches, design_stats(log, None, card, 'ESM-on design, ESM '
                                  'reuse')


def phase_design_esm_flash(torch, card, rt, complexes):
    """Phase 6c: the ESM-on design of phase 6 on its runtime with the ESM
    attention on the flash route (ABX_FUSED_ESM_ATTN=0 ABX_FLASH_ESM=1),
    through the runner API."""
    from abx_tpu_torch.cli import runner
    ws = wrappers()
    expected = {k: n * PASSES for k, n in PER_PASS.items()}
    expected['esm_flash_attention'] = ESM_LAYERS * PASSES
    expected['esm_layer_norm'] = esm_ln_launches(ESM_LAYERS, PASSES)
    env = ESM_ROUTES['flash']
    with tempfile.TemporaryDirectory() as out:
        os.environ.update(env)
        try:
            reset_counts(ws)
            log = runner.run_sampling(
                rt, os.path.join(out, 'design'), complexes,
                num_samples=NUM_SAMPLES, num_t=NUM_T, seed=0,
                batch_samples=NUM_SAMPLES)
            torch.cuda.synchronize()
            launches = read_counts(ws)
        finally:
            for k in env:
                os.environ.pop(k)
        check_design(out, launches, expected,
                     'ESM-on design, flash route')
    return launches, design_stats(log, None, card, 'ESM-on design, flash '
                                  'route')


def design_batch(rt, n=NUM_SAMPLES):
    """The 6ct7 complex as a device batch of `n` samples."""
    import numpy as np
    from abx_tpu_torch.cli import runner
    from abx_tpu_torch.data import dataset as ds
    from abx_tpu_torch.sampling.sampler import to_device_batch
    feats, _ = next(runner.load_complexes(None, None, PDB, rt))
    return to_device_batch({k: np.repeat(v, n, axis=0)
                            for k, v in ds.stack_batch([feats]).items()},
                           rt.device)


CHUNK = 3       # phase 10's grid positions a chunk
BB_TOL = 0.1    # A, backbone atoms


class Killed(Exception):
    """Phase 10's process dying mid-trajectory."""


def phase_resumable(torch, rt):
    """Phase 10: ESM-off sample_resumable (chunks of CHUNK grid positions)
    whole, and killed as its second chunk starts (the first chunk's state
    on disk) and then resumed, against sample with the same generator
    seed: identical sequences, backbone within BB_TOL.  The launches are
    those of the killed run and its resume: one trajectory's worth."""
    from abx_tpu_torch.sampling.sampler import Sampler, SamplerConfig
    ws = wrappers()
    feats = design_batch(rt)
    sampler = Sampler(rt.model, rt.diffuser, rt.config.model,
                      SamplerConfig(num_t=NUM_T))

    def gen():
        return torch.Generator(device='cuda').manual_seed(5)
    want = sampler.sample(feats, gen())
    whole = sampler.sample_resumable(feats, gen(), chunk_steps=CHUNK)
    run_steps = sampler._run_steps
    chunks = []

    def die_on_second_chunk(*args, **kwargs):
        if chunks:
            raise Killed
        chunks.append(1)
        return run_steps(*args, **kwargs)
    with tempfile.TemporaryDirectory() as d:
        state = os.path.join(d, 'state.npz')
        torch.cuda.synchronize()
        reset_counts(ws)
        sampler._run_steps = die_on_second_chunk
        try:
            sampler.sample_resumable(feats, gen(), chunk_steps=CHUNK,
                                     state_path=state)
            fail('resumable: the killed run ran to the end')
        except Killed:
            pass
        finally:
            del sampler._run_steps
        if not os.path.exists(state):
            fail('resumable: no state file after the first chunk')
        resumed = sampler.sample_resumable(feats, gen(), chunk_steps=CHUNK,
                                           state_path=state)
        torch.cuda.synchronize()
        launches = read_counts(ws)
        if os.path.exists(state):
            fail('resumable: the state file outlived the run')
    report = {}
    for what, got in (('whole', whole), ('resumed', resumed)):
        if not torch.equal(got['seq'], want['seq']):
            fail(f'resumable ({what}): sequences differ from sample')
        if not torch.isfinite(got['atom14']).all():
            fail(f'resumable ({what}): non-finite coordinates')
        dev = (got['atom14'][..., :4, :] - want['atom14'][..., :4, :]
               ).abs().max().item()
        if dev > BB_TOL:
            fail(f'resumable ({what}): backbone {dev:.3g} A from sample')
        report[f'{what}_max_backbone_dev_A'] = dev
    check_launches(launches, {k: n * PASSES for k, n in PER_PASS.items()},
                   'resumable')
    print(f'resumable (num_t {NUM_T}, chunks of {CHUNK}): sequences '
          f'identical to sample, backbone {report}', flush=True)
    return launches, report


def phase_bench(torch, rt_off, rt_esm):
    """The bench's per-config function on the runtimes already built, at
    num_t 2 and one rep, for no_esm and esm_reuse; prints its JSON line."""
    from abx_tpu_torch.tools import bench
    runtimes = {'no_esm': rt_off, 'esm': rt_esm}
    configs = {name: bench.bench_config(name, runtimes, num_t=2,
                                        batch=NUM_SAMPLES, reps=1)
               for name in ('no_esm', 'esm_reuse')}
    for name, detail in configs.items():
        if 'samples_per_hr' not in detail:
            fail(f'bench smoke {name}: {detail}')
    print(json.dumps({'bench_smoke': configs}), flush=True)
    return configs


def write_test_set(torch, out):
    """npz files of the test complexes, as the port's complex_from_pdb
    writes them, and their name index."""
    import numpy as np
    from abx_tpu_torch.data import dataset as ds
    names = []
    for pdb in TEST_SET:
        name = os.path.basename(pdb)[:-4]
        parts = name.split('_')
        ex = ds.complex_from_pdb(pdb, parts[1], parts[2], parts[3].split('|'))
        np.savez(os.path.join(out, f'{name}.npz'), **ex)
        names.append(name)
    index = os.path.join(out, 'names.txt')
    with open(index, 'w') as f:
        f.write('\n'.join(names) + '\n')
    return names, index


def chains_of(name):
    return name.split('_', 1)[1].replace('|', '_').split('_')


def phase_optimize(torch, card):
    """Phase 7: test-set CDR optimization through the inference CLI in the
    opt-in kernel configuration."""
    from abx_tpu_torch.cli import inference
    from abx_tpu_torch.sampling.sampler import Sampler, SamplerConfig
    ws = wrappers()
    n_steps = len(Sampler(None, None, None, SamplerConfig(
        num_t=NUM_T, mode='optimize', opt_step=OPT_STEP)).reverse_steps)
    with tempfile.TemporaryDirectory() as data, \
            tempfile.TemporaryDirectory() as out:
        names, index = write_test_set(torch, data)
        passes = (n_steps + 1) * (NUM_RECYCLE + 1) * len(names)
        expected = {k: n * passes for k, n in OPT_PER_PASS.items()}
        argv = ['--data_dir', data, '--name_idx', index, '--output_dir', out,
                '--mode', 'optimize', '--optimize_steps', str(OPT_STEP),
                '--num_t', str(NUM_T), '--num_samples', str(NUM_SAMPLES),
                '--batch_samples', str(NUM_SAMPLES), '--bf16',
                '--model_config', MODEL_CONFIG, '--seed', '0', '--device',
                'cuda']
        set_flags(OPT_IN)
        reset_counts(ws)
        t0 = time.time()
        log = inference.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_counts(ws)
        set_flags({})
        for name in names:
            for i in range(NUM_SAMPLES):
                path = os.path.join(out, 'optimize', f'OPT-{OPT_STEP}',
                                    f'{i:04d}', f'{name}.pdb')
                if not os.path.exists(path):
                    fail(f'optimize wrote no {path}')
                check_pdb(path, chains_of(name))
            check_pdb(os.path.join(out, 'optimize', 'reference',
                                   f'{name}.pdb'), chains_of(name))
        check_launches(launches, expected, 'optimize (opt-in kernels)')
    if [n for n, _, _ in log] != names:
        fail(f'optimize sampled {[n for n, _, _ in log]}, expected {names}')
    sampling_s = sum(e for _, _, e in log)
    steps = (n_steps + 1) * len(names)
    sph = NUM_SAMPLES * len(names) / sampling_s * 3600.0
    print(f'optimize, opt-in kernels (bf16, B=4, L=288, num_recycle 2, '
          f'num_t {NUM_T}, opt_step {OPT_STEP}: {n_steps} steps + prime per '
          f'complex, {len(names)} complexes) on {card}: wall {wall:.2f} s '
          f'incl. model build, sampling {sampling_s:.2f} s, '
          f'{sampling_s / steps:.3f} s per diffusion step, {sph:.1f} '
          f'samples/hour', flush=True)
    return launches, {'wall_s': wall, 'sampling_s': sampling_s,
                      's_per_step': sampling_s / steps,
                      'samples_per_hour': sph, 'passes': passes}


def phase_trajectory(torch):
    """Trajectory mode at the default flags on 6ct7: one <name>@<t>.pdb per
    reverse step."""
    from abx_tpu_torch.cli import inference
    ws = wrappers()
    passes = (TRAJ_NUM_T + 1) * (NUM_RECYCLE + 1)
    expected = {k: n * passes for k, n in PER_PASS.items()}
    with tempfile.TemporaryDirectory() as data, \
            tempfile.TemporaryDirectory() as out:
        names, _ = write_test_set(torch, data)
        index = os.path.join(data, 'first.txt')
        with open(index, 'w') as f:
            f.write(names[0] + '\n')
        reset_counts(ws)
        inference.main(['--data_dir', data, '--name_idx', index,
                        '--output_dir', out, '--mode', 'trajectory',
                        '--num_t', str(TRAJ_NUM_T), '--num_samples', '1',
                        '--bf16', '--model_config', MODEL_CONFIG, '--seed',
                        '0', '--device', 'cuda'])
        torch.cuda.synchronize()
        launches = read_counts(ws)
        sdir = os.path.join(out, 'trajectory', '0000')
        files = sorted(f for f in os.listdir(sdir)
                       if f.startswith(f'{names[0]}@'))
        if len(files) != TRAJ_NUM_T:
            fail(f'trajectory wrote {files}, expected {TRAJ_NUM_T} steps')
        for f in files:
            check_pdb(os.path.join(sdir, f), chains_of(names[0]))
        check_launches(launches, expected, 'trajectory')
    print(f'trajectory (num_t {TRAJ_NUM_T}) wrote {files}', flush=True)
    return launches


def write_seqres_pdb(path):
    """testdata/6ct7_H_L_S.pdb with SEQRES records for chain H and
    residues 30-35 of H's ATOM records dropped; returns the SEQRES
    sequence."""
    from abx_tpu_torch.common import residue_constants as rc
    from abx_tpu_torch.data import pdb_io
    h = pdb_io.parse_pdb(PDB)['H']
    three = [rc.restype_1to3[c] for c in h.str_seq]
    lines = [f'SEQRES {i // 13 + 1:>3d} H {len(three):>4d}  '
             + ' '.join(three[i:i + 13]) for i in range(0, len(three), 13)]
    drop = {(r, ' ') for r in h.resseq[30:36]}
    with open(PDB) as f:
        for line in f.read().splitlines():
            if line[:6] == 'ATOM  ' and line[21] == 'H' and \
                    (int(line[22:26]), line[26]) in drop:
                continue
            lines.append(line)
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return h.str_seq


def phase_seqres(torch, card):
    """Phase 9: ESM-off design through the design CLI with --use_seqres on
    a copy of 6ct7 whose chain H has SEQRES records and a 6-residue gap."""
    from abx_tpu_torch.cli import design
    from abx_tpu_torch.data import dataset as ds
    from abx_tpu_torch.data import pdb_io
    ws = wrappers()
    expected = {k: n * PASSES for k, n in PER_PASS.items()}
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as out:
        path = os.path.join(d, '6ct7_H_L_S.pdb')
        seqres = write_seqres_pdb(path)
        if pdb_io.parse_seqres(path)['H'] != seqres:
            fail('SEQRES: parse_seqres did not read the H records back')
        # The npz schema holds H's variable domain: re-indexed onto SEQRES
        # it has the intact structure's length, the 6 dropped residues
        # present and unobserved.
        ex = ds.complex_from_pdb(path, 'H', 'L', ['S'], use_seqres=True)
        gap = ds.complex_from_pdb(path, 'H', 'L', ['S'])
        full = ds.complex_from_pdb(PDB, 'H', 'L', ['S'])
        n_h = [int((e['antibody_chain_ids'] == 0).sum())
               for e in (ex, gap, full)]
        unobserved = int((~ex['antibody_coord_mask'][:, 1].astype(bool)
                          ).sum()) - int(
            (~full['antibody_coord_mask'][:, 1].astype(bool)).sum())
        if n_h[0] != n_h[2] or n_h[1] != n_h[2] - 6 or unobserved != 6:
            fail(f'SEQRES: H lengths (seqres, gapped, intact) {n_h}, '
                 f'{unobserved} residues unobserved, expected 6')
        argv = ['--pdb_file', path, '--output_dir', out, '--model_config',
                MODEL_CONFIG, '--seed', '0', '--bf16', '--device', 'cuda',
                '--num_samples', str(NUM_SAMPLES), '--batch_samples',
                str(NUM_SAMPLES), '--num_t', str(NUM_T), '--use_seqres',
                '--verbose']
        reset_counts(ws)
        t0 = time.time()
        log = design.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_counts(ws)
        check_design(out, launches, expected, 'SEQRES design')
    print(f'SEQRES design: H of the npz schema {n_h[0]} residues with '
          f'SEQRES (gapped {n_h[1]}, intact {n_h[2]}; SEQRES chain '
          f'{len(seqres)})', flush=True)
    stats = design_stats(log, wall, card, 'SEQRES design')
    stats['h_len_seqres_gapped_intact'] = n_h
    return launches, stats


PLL_BATCH = 32      # phase 11: masked positions a batch (evaluation/pll.py)


def non_cdr_coords(path):
    """Coordinates of every present atom outside the CDRs of H and L, and of
    the antigen S, in file order."""
    import numpy as np
    from abx_tpu_torch.common import residue_constants as rc
    from abx_tpu_torch.data.pdb_io import parse_pdb
    from abx_tpu_torch.preprocess.numbering import annotate_domain
    chains = parse_pdb(path)
    out = []
    for cid in ('H', 'L', 'S'):
        ch = chains[cid]
        keep = np.ones(len(ch.str_seq), bool)
        ann = annotate_domain(ch.str_seq, cid) if cid != 'S' else None
        if ann is not None:
            cdr = np.isin(ann.cdr_def, list(rc.cdr_str_to_enum.values()))
            keep[ann.start:ann.end] = ~cdr
        out.append(ch.coords[keep][ch.coord_mask[keep]])
    return np.concatenate(out)


def random_lm_checkpoint(torch, path, cfg):
    """A fair-esm-style `.pt` of an ESM2 of shape `cfg` with its masked-LM
    head (torch's default init from seed 0), the head's projection tied to
    the token embedding as fair-esm saves it."""
    from abx_tpu_torch.models.esm import ESM2, ESM2LMHead
    torch.manual_seed(0)
    enc, head = ESM2(cfg), ESM2LMHead(cfg)
    sd = dict(enc.state_dict())
    sd.update({f'lm_head.{k}': v for k, v in head.state_dict().items()})
    sd['lm_head.weight'] = sd['embed_tokens.weight']
    torch.save({'model': sd}, path)


def phase_eval(torch, card, out):
    """Phase 11: the evaluation path on phase 5's designs (`out/design`,
    with `reference/`): relax, violations and metrics, ESM2-3B masked PLL
    through the library, and the PLL CLI on a small checkpoint."""
    import csv
    import math
    import numpy as np
    from abx_tpu_torch.cli import (eval_metric, eval_pll, eval_violations,
                                   relax_pdb)
    from abx_tpu_torch.data.pdb_io import parse_pdb
    from abx_tpu_torch.evaluation.pll import masked_pll
    from abx_tpu_torch.models.esm import ESM2, ESM2Config, ESM2LMHead
    design = os.path.join(out, 'design')
    relaxed = os.path.join(out, 'relaxed')
    names = [os.path.join(f'{i:04d}', '6ct7_H_L_S') for i in
             range(NUM_SAMPLES)]
    ws = wrappers()
    stats, paths = {}, {}

    # 1. The gradient relaxer on the card, on the 4 designs.
    t0 = time.time()
    done = relax_pdb.main(['--data_dir', design, '--output_dir', relaxed,
                           '--device', 'cuda'])
    torch.cuda.synchronize()
    per = (time.time() - t0) / NUM_SAMPLES
    if len(done) != NUM_SAMPLES:
        fail(f'relax_pdb relaxed {len(done)} of {NUM_SAMPLES} designs')
    for name in names:
        src = os.path.join(design, name + '.pdb')
        dst = os.path.join(relaxed, name + '_relaxed.pdb')
        if not os.path.exists(dst):
            fail(f'relax_pdb wrote no {dst}')
        check_pdb(dst)
        # The relaxer minimises 10 (bond + clash) + restraint, the restraint
        # 0 before: energy and bond + clash must not rise.  A term alone
        # may (the clash rose 4.79e-6 -> 5.46e-6 on one design as its
        # energy fell 37.60 -> 32.84; as in the JAX package's relaxer).
        m = done[src]
        if not (m['energy_after'] <= m['energy_before']
                and m['bond_after'] + m['clash_after']
                <= m['bond_before'] + m['clash_before']):
            fail(f'relax of {src}: {m}')
        before, after = non_cdr_coords(src), non_cdr_coords(dst)
        if before.shape != after.shape or not np.array_equal(before, after):
            fail(f'relax of {src} moved atoms outside the CDRs')
    energy = [(m['energy_before'], m['energy_after'],
               m['clash_before'], m['clash_after']) for m in done.values()]
    print(f'relax (200 Adam steps, f32) on {card}: {per:.2f} s per '
          f'structure; (energy, clash) before -> after: '
          + '; '.join(f'({a:.5g}, {c:.4g}) -> ({b:.5g}, {d:.4g})'
                      for a, b, c, d in energy), flush=True)
    stats['relax_s_per_structure'] = per
    stats['relax_metrics'] = list(done.values())

    # 2. Violations of the relaxed files, metrics of the designs.
    vio_csv = os.path.join(out, 'violations.csv')
    eval_violations.main(['--data_dir', relaxed, '--output_csv', vio_csv,
                          '--device', 'cuda'])
    with open(vio_csv, newline='') as f:
        vio = list(csv.DictReader(f))
    if len(vio) != NUM_SAMPLES or not all(
            math.isfinite(float(r[k])) for r in vio
            for k in ('total', 'bond', 'clash', 'within')):
        fail(f'eval_violations: {vio}')
    res_csv = os.path.join(out, 'results.csv')
    eval_metric.main(['--data_dir', design, '--output_csv', res_csv])
    with open(res_csv, newline='') as f:
        res = list(csv.DictReader(f))
    if len(res) != NUM_SAMPLES or not all(
            math.isfinite(float(r['full_rmsd']))
            and 0.0 <= float(r['h3_aar']) <= 1.0 for r in res):
        fail(f'eval_metric: {res}')
    stats['violations'] = vio
    stats['metrics'] = [{k: r[k] for k in ('name', 'full_rmsd', 'h3_rmsd',
                                           'h3_aar')} for r in res]
    print(f'eval_violations and eval_metric: {len(vio)} and {len(res)} rows; '
          f'full_rmsd {[round(float(r["full_rmsd"]), 3) for r in res]}, '
          f'h3_aar {[round(float(r["h3_aar"]), 3) for r in res]}',
          flush=True)

    # 3. Full-width masked PLL: ESM2-t36-3B with its LM head in f32, random
    # weights made on the card (0.02 N(0, 1), as runner._random_esm).
    torch.cuda.empty_cache()
    dev = torch.device('cuda')
    cfg = ESM2Config.t36_3B()
    esm = ESM2(cfg, torch.float32, device='meta').to_empty(device=dev)
    head = ESM2LMHead(cfg, torch.float32, device='meta').to_empty(device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for prm in [*esm.parameters(), *head.parameters()]:
            prm.normal_(0.0, 0.02, generator=g)
    esm.eval()
    head.eval()
    chains = [parse_pdb(os.path.join(design, n + '.pdb')) for n in names]
    seqs = [c[cid].str_seq for c in chains for cid in ('H', 'L')]
    batches = sum(-(-len(sq) // PLL_BATCH) for sq in seqs)
    reset_counts(ws)
    t0 = time.time()
    plls = [masked_pll(esm, lambda f: head(f, esm.embed_tokens.weight), sq)
            for sq in seqs]
    torch.cuda.synchronize()
    wall = time.time() - t0
    paths['eval_pll'] = read_counts(ws)
    check_launches(paths['eval_pll'],
                   {'esm_attention': cfg.num_layers * batches,
                    'esm_layer_norm': esm_ln_launches(cfg.num_layers,
                                                      batches, batches)},
                   'eval_pll (ESM2-3B, f32)')
    if not all(math.isfinite(x) and x <= 0.0 for x in plls):
        fail(f'masked PLL: {plls}')
    print(f'masked PLL, ESM2-t36-3B f32 on {card}: {len(seqs)} chains '
          f'(lengths {[len(sq) for sq in seqs]}), {batches} batches, '
          f'{wall:.2f} s, {wall / len(seqs):.3f} s per chain; PLL '
          f'{[round(x, 4) for x in plls]}', flush=True)
    stats['pll_s_per_chain'] = wall / len(seqs)
    stats['pll'] = plls
    del esm, head
    torch.cuda.empty_cache()

    # 4. The PLL CLI on a random t12_35M-shaped fair-esm checkpoint.
    small = ESM2Config.t12_35M()
    with tempfile.TemporaryDirectory() as d:
        pt = os.path.join(d, 'esm2_t12_35M_random.pt')
        random_lm_checkpoint(torch, pt, small)
        pll_csv = os.path.join(out, 'pll.csv')
        reset_counts(ws)
        t0 = time.time()
        rows = eval_pll.main(['--data_dir', design, '--esm_checkpoint', pt,
                              '--num_layers', str(small.num_layers),
                              '--embed_dim', str(small.embed_dim),
                              '--output_csv', pll_csv, '--device', 'cuda'])
        torch.cuda.synchronize()
        wall = time.time() - t0
    paths['eval_pll_cli'] = read_counts(ws)
    check_launches(paths['eval_pll_cli'],
                   {'esm_attention': small.num_layers * batches,
                    'esm_layer_norm': esm_ln_launches(small.num_layers,
                                                      batches, batches)},
                   'eval_pll CLI (t12_35M shape, f32)')
    if not os.path.exists(pll_csv) or len(rows) != len(seqs) or not all(
            math.isfinite(r['pll']) and r['pll'] <= 0.0 for r in rows):
        fail(f'eval_pll CLI: {rows}')
    print(f'eval_pll CLI (t12_35M shape, f32): {len(rows)} rows in '
          f'{wall:.2f} s incl. loading', flush=True)
    return paths, stats


TRAIN_STEPS, TRAIN_RESUME_TO, TRAIN_BATCH, TRAIN_ESM_STEPS = 4, 6, 4, 3
TRAIN_CKPT_EVERY = 2


def read_metrics(path):
    import csv
    with open(path, newline='') as f:
        return list(csv.DictReader(f))


def check_train_rows(rows, steps, what):
    import math
    if [int(r['step']) for r in rows] != steps:
        fail(f'{what}: metrics.csv steps {[r["step"] for r in rows]}, '
             f'expected {steps}')
    for r in rows:
        total, g = float(r['total']), float(r['grad_norm'])
        if not (math.isfinite(total) and math.isfinite(g) and g > 0):
            fail(f'{what}: step {r["step"]} total {total}, grad_norm {g}')


def train_argv(data, index, out, steps):
    return ['--data_dir', data, '--name_idx', index, '--output_dir', out,
            '--model_config', MODEL_CONFIG, '--seed', '0', '--device',
            'cuda', '--batch_size', str(TRAIN_BATCH), '--log_every', '1',
            '--checkpoint_every', str(TRAIN_CKPT_EVERY), '--num_steps',
            str(steps)]


def step_seconds(rows, first_steps, save_every=0):
    """Median seconds per step from the CLI's steps_per_sec (the host time
    between rows), over the steps that carry neither a run's warm-up (the
    steps in `first_steps`) nor a checkpoint save (the step after each
    `save_every`-th of its run); with each kept step's (recycle passes
    drawn, seconds)."""
    steps, start = [], 0
    for r in rows:
        step = int(r['step'])
        if step in first_steps:
            start = step - 1
            continue
        if save_every and (step - 1 - start) % save_every == 0:
            continue
        steps.append((int(float(r['num_recycle'])),
                      1.0 / float(r['steps_per_sec'])))
    return statistics.median(s for _, s in steps), steps


def top_gradients(model, k=3):
    """The global gradient norm and the `k` parameters with the largest
    gradient norms, from the gradients the model holds."""
    import math
    norms = {name: float(p.grad.norm()) for name, p in
             model.named_parameters() if p.grad is not None}
    top = sorted(norms, key=norms.get, reverse=True)[:k]
    return (math.sqrt(sum(v * v for v in norms.values())),
            [(name, norms[name]) for name in top])


def phase_train(torch, card):
    """Phase 12: the training path.  ESM off through the training CLI (f32,
    full width, B=4, random weights from seed 0): 4 steps with checkpoints
    every 2, then --resume to a total of 6; the trunk kernels never launch.
    ESM2-3B on (random weights made on the card, frozen) through the
    runner and the Trainer: esm_attention 36 x the trunk passes the steps
    drew.  Then a design from the EMA weights the ESM-off run wrote."""
    import math
    from abx_tpu_torch.cli import design, runner, train
    from abx_tpu_torch.data.pipeline import prefetch
    from abx_tpu_torch.train.trainer import TrainConfig, Trainer
    from abx_tpu_torch.utils import checkpoint as ckpt_lib
    ws = wrappers()
    paths, stats = {}, {}
    with tempfile.TemporaryDirectory() as data, \
            tempfile.TemporaryDirectory() as tmp:
        names, index = write_test_set(torch, data)
        out = os.path.join(tmp, 'run')
        ckpt = os.path.join(out, train.CHECKPOINT)

        # ESM off: 4 steps, then the resume to 6.
        torch.cuda.reset_peak_memory_stats()
        reset_counts(ws)
        t0 = time.time()
        state = train.main(train_argv(data, index, out, TRAIN_STEPS))
        torch.cuda.synchronize()
        wall = time.time() - t0
        first = read_metrics(os.path.join(out, 'metrics.csv'))
        check_train_rows(first, list(range(1, TRAIN_STEPS + 1)),
                         'train (ESM off)')
        state = train.main(train_argv(data, index, out, TRAIN_RESUME_TO)
                           + ['--resume'])
        torch.cuda.synchronize()
        launches = read_counts(ws)
        peak = torch.cuda.max_memory_allocated() / 1e9
        rows = read_metrics(os.path.join(out, 'metrics.csv'))
        check_train_rows(rows, list(range(1, TRAIN_RESUME_TO + 1)),
                         'train (ESM off, resumed)')
        if state.step != TRAIN_RESUME_TO:
            fail(f'train: resumed run ended at step {state.step}')
        check_launches(launches, {}, 'train (ESM off, f32)')
        files = sorted(os.listdir(out))
        want = ['metrics.csv', train.CHECKPOINT, train.CHECKPOINT + '.raw',
                train.CHECKPOINT + '.train']
        if files != want:
            fail(f'train: output files {files}, expected {want}')
        init = runner.build_runtime(MODEL_CONFIG, seed=0, device='cpu')
        init_sd = init.model.state_dict()
        raw = ckpt_lib.load_params(ckpt + '.raw')
        ema = ckpt_lib.load_params(ckpt)
        if all(torch.equal(raw[k], init_sd[k]) for k in init_sd):
            fail('train: the raw weights equal the initial ones')
        if all(torch.equal(raw[k], ema[k]) for k in raw):
            fail('train: the EMA weights equal the raw ones')
        del init, init_sd
        s_step, steps = step_seconds(rows, {1, TRAIN_STEPS + 1},
                                     TRAIN_CKPT_EVERY)
        recycles = [int(float(r['num_recycle'])) for r in rows]
        print(f'train, ESM off (f32, B={TRAIN_BATCH}, L=288, full width) on '
              f'{card}: {s_step:.3f} s per step (median of the steps after '
              f'neither a run\'s first nor a save; (recycle passes, s) of '
              f'those steps: '
              f'{[(n, round(t, 3)) for n, t in steps]}; recycles drawn '
              f'{recycles}), first run {wall:.2f} s wall incl. model build '
              f'for {TRAIN_STEPS} steps, peak memory allocated {peak:.2f} '
              f'GB', flush=True)
        stats['train_esm_off'] = {
            's_per_step': s_step, 'steps': steps, 'wall_s': wall,
            'peak_gb': peak, 'num_recycle': recycles,
            'total': [float(r['total']) for r in rows],
            'grad_norm': [float(r['grad_norm']) for r in rows]}
        paths['train_esm_off'] = launches

        # ESM2-3B on, through the runner and the Trainer.
        torch.cuda.reset_peak_memory_stats()
        rt = runner.build_runtime(MODEL_CONFIG, seed=0, device='cuda',
                                  esm_random=True)
        trainer = Trainer(rt.model, rt.diffuser, rt.config.model,
                          rt.config.loss, TrainConfig(log_every=1),
                          esm=rt.esm)
        it = prefetch(train.batch_iterator(data, names, rt.data_config,
                                           TRAIN_BATCH, False, 0),
                      size=2, device_put_ahead=True, device=rt.device)
        metrics_path = os.path.join(tmp, 'esm_metrics.csv')
        reset_counts(ws)
        trainer.fit(trainer.init_state(), it, TRAIN_ESM_STEPS,
                    torch.Generator(device=rt.device).manual_seed(0),
                    metrics_path=metrics_path)
        torch.cuda.synchronize()
        launches = read_counts(ws)
        peak_esm = torch.cuda.max_memory_allocated() / 1e9
        rows = read_metrics(metrics_path)
        check_train_rows(rows, list(range(1, TRAIN_ESM_STEPS + 1)),
                         'train (ESM2-3B)')
        passes = sum(int(float(r['num_recycle'])) + 1 for r in rows)
        check_launches(launches, {'esm_attention': ESM_LAYERS * passes},
                       'train (ESM2-3B, f32)')
        if any(p.grad is not None for p in rt.esm.parameters()):
            fail('train (ESM2-3B): an ESM parameter has a gradient')
        lw = rt.model.seqformer.esm_embed_weights.grad
        if lw is None or not torch.isfinite(lw).all() or \
                float(lw.abs().sum()) == 0.0:
            fail(f'train (ESM2-3B): layer-weight gradient {lw}')
        s_esm, steps = step_seconds(rows, {1})
        g_last, g_top = top_gradients(rt.model)
        print(f'train, ESM2-3B on (f32, B={TRAIN_BATCH}, L=288, frozen '
              f'random ESM) on {card}: {s_esm:.3f} s per step after the '
              f'first ((recycle passes, s): '
              f'{[(n, round(t, 3)) for n, t in steps]}; {passes} trunk '
              f'passes in {TRAIN_ESM_STEPS} steps), peak memory allocated '
              f'{peak_esm:.2f} GB; the last step\'s gradient norm '
              f'{g_last:.4g}, largest leaves {g_top}', flush=True)
        stats['train_esm_on'] = {
            's_per_step': s_esm, 'steps': steps, 'peak_gb': peak_esm,
            'passes': passes,
            'total': [float(r['total']) for r in rows],
            'grad_norm': [float(r['grad_norm']) for r in rows],
            'layer_weight_grad_abs_sum': float(lw.abs().sum()),
            'last_grad_norm': g_last, 'last_grad_top_leaves': g_top}
        paths['train_esm_on'] = launches
        del rt, trainer, it
        torch.cuda.empty_cache()

        # Design from the EMA weights the ESM-off run wrote.
        dout = os.path.join(tmp, 'design_out')
        reset_counts(ws)
        design.main(['--pdb_file', PDB, '--output_dir', dout,
                     '--model_config', MODEL_CONFIG, '--model', ckpt,
                     '--seed', '0', '--bf16', '--device', 'cuda',
                     '--num_samples', str(NUM_SAMPLES), '--batch_samples',
                     str(NUM_SAMPLES), '--num_t', str(NUM_T)])
        torch.cuda.synchronize()
        launches = read_counts(ws)
        check_design(dout, launches,
                     {k: n * PASSES for k, n in PER_PASS.items()},
                     'design from the trained weights')
        paths['design_trained'] = launches
    if not math.isfinite(s_step) or not math.isfinite(s_esm):
        fail('train: step time not finite')
    return paths, stats


# --- phase 13: Picard, tensor-parallel ESM2, multi-host inference, data-
# parallel training, tracing -------------------------------------------------

PICARD_F32 = (2, 4)      # (B, num_t): grid 5, 10 rows a sweep
PICARD_BF16 = (4, 8)     # the flagship: grid 9, 36 rows a sweep
TP, TP_NUM_T = 2, 2      # tensor-parallel ranks; the TP design's num_t
MH_HOSTS, MH_NUM_T, MH_SAMPLES = 2, 4, 2
DP_RANKS, DP_BATCH = 2, 4
DP_LOSS_TOL, DP_GRAD_TOL, DP_WEIGHT_TOL = 1e-5, 1e-4, 1e-4
# Adam's first update of an element is g / (|g| + 1e-8) of the clipped
# gradient: where |g| is near the two runs' gradient difference or near
# Adam's eps, it magnifies that difference past any bar on the weights.
# The weights are held where the two runs' own gradients move that update
# by at most a tenth of the bar.
ADAM_EPS, HELD_SHARE_OF_BAR = 1e-8, 0.1
CHILD_TIMEOUT = 600
CHILD_TAG = 'chip_smoke child result: '
TRACE_SPAN = 'abx_trunk_pass'
# Device kernel names of rows 1-7 (the row-linear core runs rows 6 and 7,
# and row 1's projections).
TRACE_KERNELS = {'triangle_attention_packed': ('flash_kernel',),
                 'pair_bias_proj': ('pair_bias_kernel',),
                 'fused_transition': ('transition_sm90_kernel',
                                      'transition_kernel'),
                 'ipa_attention': ('ipa_kernel',),
                 'recycle_embed': ('recycle_kernel',),
                 'tri_mult_pre / tri_mult_post': ('linear_sm90_kernel',
                                                  'linear_kernel')}


def passes_launches(per_pass, passes):
    return {k: n * passes for k, n in per_pass.items()}


def add_counts(counts):
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def picard_run(torch, rt, b, num_t, seed=0):
    """Sampler.sample_prepared and picard_sample_prepared on the same
    prepared 6ct7 batch of `b` samples and the same per-step noise; the
    Picard run's launches, and both runs' seconds."""
    from abx_tpu_torch.sampling.picard import (draw_noise,
                                               picard_sample_prepared)
    from abx_tpu_torch.sampling.sampler import Sampler, SamplerConfig
    ws = wrappers()
    sampler = Sampler(rt.model, rt.diffuser, rt.config.model,
                      SamplerConfig(num_t=num_t))
    gen = torch.Generator(device='cuda').manual_seed(seed)
    prepared = sampler.prepare(design_batch(rt, b), gen)
    grid = len(sampler.step_grids()[0])
    noise = draw_noise(gen, grid, b, prepared['seq'].shape[1],
                       device=rt.device)
    torch.cuda.synchronize()
    t0 = time.time()
    want = sampler.sample_prepared(prepared, None, noise)
    torch.cuda.synchronize()
    seq_s = time.time() - t0
    reset_counts(ws)
    t0 = time.time()
    got = picard_sample_prepared(sampler, prepared, None, noise, tol=0.0)
    torch.cuda.synchronize()
    pic_s = time.time() - t0
    launches = read_counts(ws)
    dev = (got['atom14'][..., :4, :] - want['atom14'][..., :4, :]
           ).abs().max().item()
    finite = bool(torch.isfinite(got['atom14']).all())
    return {'grid': grid, 'rows': grid * b, 'sweeps': got['picard']['sweeps'],
            'deltas': got['picard']['deltas'], 'picard_s': pic_s,
            'sequential_s': seq_s, 'seq_equal':
            bool(torch.equal(got['seq'], want['seq'])),
            'seq_sites_differ': int((got['seq'] != want['seq']).sum()),
            'max_backbone_dev_A': dev, 'finite': finite}, launches


def phase_picard(torch, card):
    """13a: Picard in f32 (fatal bars) and at the bf16 flagship (reported)."""
    from abx_tpu_torch.cli import runner
    paths, stats = {}, {}
    for what, bf16, (b, num_t) in (('picard_f32', False, PICARD_F32),
                                   ('picard_bf16', True, PICARD_BF16)):
        rt = runner.build_runtime(MODEL_CONFIG, seed=0, bf16=bf16,
                                  device='cuda')
        st, launches = picard_run(torch, rt, b, num_t)
        del rt
        torch.cuda.empty_cache()
        check_launches(launches, passes_launches(
            PER_PASS, (NUM_RECYCLE + 1) * st['sweeps']), what)
        print(f'{what} (B={b}, num_t {num_t}: {st["rows"]} rows a sweep, '
              f'L=288) on {card}: {st["sweeps"]} sweeps in '
              f'{st["picard_s"]:.2f} s (sequential {st["sequential_s"]:.2f}'
              f' s), deltas {st["deltas"]}, sequences equal to the '
              f'sequential run: {st["seq_equal"]} ({st["seq_sites_differ"]} '
              f'sites differ), backbone {st["max_backbone_dev_A"]:.3g} A',
              flush=True)
        if not st['finite']:
            fail(f'{what}: non-finite coordinates')
        if not bf16:
            if st['deltas'][-1] != 0.0 or st['sweeps'] > st['grid'] + 1:
                fail(f'picard f32: no bitwise fixpoint within grid + 1 '
                     f'sweeps: {st["deltas"]}')
            if not st['seq_equal'] or st['max_backbone_dev_A'] > BB_TOL:
                fail(f'picard f32 vs sequential: sequences equal '
                     f'{st["seq_equal"]}, backbone '
                     f'{st["max_backbone_dev_A"]:.3g} A')
        paths[what], stats[what] = launches, st
    return paths, stats


def trace_events_under(trace, span):
    """Names of the device kernels whose interval lies inside the host
    span `span` of a Chrome trace (the span synchronises at both ends), or
    inside its device-side annotation."""
    ev = trace['traceEvents']
    spans = [(e['ts'], e['ts'] + e.get('dur', 0)) for e in ev
             if e.get('name') == span and e.get('ph') == 'X']
    return [e['name'] for e in ev if e.get('cat') == 'kernel' and any(
        a <= e['ts'] and e['ts'] + e.get('dur', 0) <= b for a, b in spans)]


def phase_trace(torch, card):
    """13e: prof.trace around one bf16 trunk pass under an annotate span;
    the trace holds rows 1-7's device kernels inside the span."""
    from abx_tpu_torch.cli import runner
    from abx_tpu_torch.sampling.sampler import Sampler, SamplerConfig
    from abx_tpu_torch.utils import prof
    ws = wrappers()
    rt = runner.build_runtime(MODEL_CONFIG, seed=0, bf16=True, device='cuda')
    sampler = Sampler(rt.model, rt.diffuser, rt.config.model,
                      SamplerConfig(num_t=NUM_T))
    prepared = sampler.prepare(design_batch(rt),
                               torch.Generator(device='cuda').manual_seed(0))
    traj, state = sampler._start(prepared)
    mb = {**traj.static, **state}
    t = torch.ones(NUM_SAMPLES, device=rt.device)
    rot_s, trans_s = rt.diffuser.score_scaling(t)
    mb.update(t=t, rot_score_scaling=rot_s, trans_score_scaling=trans_s)
    with torch.no_grad():
        rt.model(mb, static_acts=traj.static_acts)          # warm-up
        with tempfile.TemporaryDirectory() as d:
            torch.cuda.synchronize()
            reset_counts(ws)
            with prof.trace(d):
                with prof.annotate(TRACE_SPAN):
                    torch.cuda.synchronize()
                    rt.model(mb, static_acts=traj.static_acts)
                    torch.cuda.synchronize()
            launches = read_counts(ws)
            path = os.path.join(d, 'trace.json')
            size = os.path.getsize(path)
            with open(path) as f:
                trace = json.load(f)
    names = trace_events_under(trace, TRACE_SPAN)
    check_launches(launches, PER_PASS, 'traced trunk pass')
    found = {row: sum(any(k in n for k in ks) for n in names)
             for row, ks in TRACE_KERNELS.items()}
    print(f'trace of one bf16 trunk pass on {card}: {size} bytes, '
          f'{len(names)} device kernels inside the "{TRACE_SPAN}" span; rows '
          f'1-7 by kernel name: {found}', flush=True)
    missing = [row for row, n in found.items() if not n]
    if missing:
        fail(f'trace: no device kernel of {missing} inside the span '
             f'({sorted(set(names))[:40]})')
    del rt
    torch.cuda.empty_cache()
    return launches, {'trace_bytes': size, 'kernels_in_span': len(names),
                      'rows_by_kernel_name': found}


def free_port():
    import socket
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_children(kind, world, extra=()):
    """`world` child processes of this script (`--child kind rank world
    port ...`), started together on the one card; each must exit 0 within
    CHILD_TIMEOUT and print one result line.  Every child is stopped on
    the way out."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=HERE)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--child', kind, str(r),
         str(world), str(port), *extra], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                fail(f'{kind}: a child ran past {CHILD_TIMEOUT} s')
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln[len(CHILD_TAG):] for ln in out.splitlines()
                 if ln.startswith(CHILD_TAG)]
        if p.returncode != 0 or len(lines) != 1:
            fail(f'{kind}: child {r} exited {p.returncode}:\n{out[-6000:]}')
        results.append(json.loads(lines[0]))
    return results


def child_join(rank, world, port):
    from abx_tpu_torch.parallel import mesh as mesh_lib
    mesh_lib.init_process_group('gloo', f'127.0.0.1:{port}', world, rank,
                                timeout_s=CHILD_TIMEOUT)


def child_tp_esm(torch, rank, world, port, args):
    """13b, one rank: ESM2-3B over a tensor-parallel gloo group on the one
    card.  The f32 weighted embedding against one process's AntibodyESM
    (rank 0), then a bf16 ESM-conditioned design with the tensor-parallel
    module as esm_fn; rank 0 writes its PDBs to args[0]."""
    import torch.distributed as dist
    from abx_tpu_torch.cli import runner
    from abx_tpu_torch.data import dataset as ds
    from abx_tpu_torch.parallel import esm_tp
    from abx_tpu_torch.parallel import mesh as mesh_lib
    from abx_tpu_torch.sampling.output import (postprocess_reference,
                                               postprocess_sample)
    from abx_tpu_torch.sampling.sampler import Sampler, SamplerConfig
    from abx_tpu_torch.utils import params as params_lib
    child_join(rank, world, port)
    dev = torch.device('cuda')
    mesh = esm_tp.mesh2d(1, world, device=dev)
    ws = wrappers()
    full, (ab, hl, ll, lw), l_ab = dense_esm(torch, dev)
    tp = esm_tp.TensorParallelAntibodyESM(mesh, full.config, l_ab,
                                          dtype=torch.float32, device='meta')
    params_lib.load_esm_params(
        tp.module, esm_tp.shard_esm_params(mesh, full.module.state_dict()),
        dev, torch.float32)
    tp.requires_grad_(False).eval()
    with torch.no_grad():
        want = full(ab, hl, ll, lw) if rank == 0 else None
        del full
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        reset_counts(ws)
        got = tp(ab, hl, ll, lw)
        torch.cuda.synchronize()
        fwd = read_counts(ws)
        t0 = time.time()
        tp(ab, hl, ll, lw)
        torch.cuda.synchronize()
        fwd_s = time.time() - t0
    both = mesh_lib.all_gather_rows(mesh.model, got[None])
    out = {'launches_forward': fwd, 'tp_forward_s': fwd_s,
           'ranks_identical': bool(torch.equal(both[0], both[1]))}
    if rank == 0:
        valid = torch.arange(l_ab, device=dev)[None] < (hl + ll)[:, None]
        d, m = rel_err(got[valid], want[valid])
        out.update(max_abs_err=d, max_abs_ref=m)
    del tp, got, want, both
    torch.cuda.empty_cache()

    rt = runner.build_runtime(MODEL_CONFIG, seed=0, bf16=True, device='cuda',
                              esm_random=True)
    tp = esm_tp.TensorParallelAntibodyESM(
        mesh, rt.esm.config, rt.esm.antibody_len,
        sep_pad_num=rt.esm.sep_pad_num, dtype=torch.bfloat16, device='meta')
    params_lib.load_esm_params(
        tp.module, esm_tp.shard_esm_params(mesh, rt.esm.module.state_dict()),
        dev, torch.bfloat16)
    rt.esm = tp.requires_grad_(False).eval()
    torch.cuda.empty_cache()
    sampler = Sampler(rt.model, rt.diffuser, rt.config.model,
                      SamplerConfig(num_t=TP_NUM_T), esm_fn=rt.esm)
    feats, meta = next(runner.load_complexes(None, None, PDB, rt))
    gen = runner.sample_generator(dev, 0, meta['name'], 0)
    torch.cuda.synchronize()
    reset_counts(ws)
    t0 = time.time()
    result, rows = runner.sample_chunk(sampler, design_batch(rt), gen,
                                       mesh_lib.local_mesh(dev))
    torch.cuda.synchronize()
    out['design_s'] = time.time() - t0
    out['launches_design'] = read_counts(ws)
    same = True
    for k in ('seq', 'atom14', 'rigids'):
        v = result[k].contiguous().view(torch.uint8)
        g = mesh_lib.all_gather_rows(mesh.model, v[None])
        same = same and bool(torch.equal(g[0], g[1]))
    out['design_ranks_identical'] = same
    if rank == 0:
        host = runner._to_host(result)
        postprocess_reference(os.path.join(args[0], 'reference'), meta,
                              ds.stack_batch([feats]))
        for i in range(rows.stop - rows.start):
            sdir = os.path.join(args[0], f'{i:04d}')
            os.makedirs(sdir, exist_ok=True)
            postprocess_sample(sdir, meta, host, i)
    dist.barrier()
    dist.destroy_process_group()
    return out


def phase_tp_esm(torch, card):
    """13b: tensor-parallel ESM2-3B over TP gloo ranks on the one card."""
    torch.cuda.empty_cache()
    passes = (TP_NUM_T + 1) * (NUM_RECYCLE + 1)
    with tempfile.TemporaryDirectory() as out:
        os.makedirs(os.path.join(out, 'reference'))
        t0 = time.time()
        res = run_children('tp_esm', TP, [out])
        wall = time.time() - t0
        for i in range(NUM_SAMPLES):
            check_pdb(os.path.join(out, f'{i:04d}', '6ct7_H_L_S.pdb'))
        check_pdb(os.path.join(out, 'reference', '6ct7_H_L_S.pdb'))
        written = sorted(os.listdir(out))
    if written != ['0000', '0001', '0002', '0003', 'reference']:
        fail(f'tp esm design wrote {written}')
    r0 = res[0]
    print(f'tensor-parallel ESM2-3B (tp {TP} gloo ranks on one card, f32, '
          f'weighted embedding of 4 x 306 tokens) on {card}: max |diff| '
          f'{r0["max_abs_err"]:.3g} against one process (max|ref| '
          f'{r0["max_abs_ref"]:.3g}); a forward {r0["tp_forward_s"]:.3f} s; '
          f'bf16 design (num_t {TP_NUM_T}, {NUM_SAMPLES} samples) '
          f'{r0["design_s"]:.2f} s; children {wall:.1f} s', flush=True)
    if r0['max_abs_err'] > F32_TOL * r0['max_abs_ref']:
        fail('tp esm: the weighted embedding differs from one process')
    for r, x in enumerate(res):
        if not (x['ranks_identical'] and x['design_ranks_identical']):
            fail(f'tp esm: rank {r} holds other bits than its peer')
        check_launches(x['launches_forward'], {
            'esm_attention': ESM_LAYERS,
            'esm_layer_norm': esm_ln_launches(ESM_LAYERS, 1)},
            f'tp esm forward (rank {r})')
        check_launches(x['launches_design'], {
            **passes_launches(PER_PASS, passes),
            'esm_attention': ESM_LAYERS * passes,
            'esm_layer_norm': esm_ln_launches(ESM_LAYERS, passes)},
            f'tp esm design (rank {r})')
    launches = add_counts([x['launches_design'] for x in res]
                          + [x['launches_forward'] for x in res])
    return launches, {'children_s': wall, **{
        k: r0[k] for k in ('max_abs_err', 'max_abs_ref', 'tp_forward_s',
                           'design_s')}}


def child_inference(torch, rank, world, port, args):
    """13c, one host: cli/inference.py under --coordinator."""
    from abx_tpu_torch.cli import inference
    ws = wrappers()
    reset_counts(ws)
    t0 = time.time()
    log = inference.main(list(args) + [
        '--coordinator', f'127.0.0.1:{port}', '--num_hosts', str(world),
        '--host_id', str(rank)])
    torch.cuda.synchronize()
    return {'names': [n for n, _, _ in log], 'launches': read_counts(ws),
            'wall_s': time.time() - t0,
            'sampling_s': sum(e for _, _, e in log)}


def phase_multihost(torch, card):
    """13c: two cli/inference.py hosts on the one card over both test
    complexes."""
    passes = (MH_NUM_T + 1) * (NUM_RECYCLE + 1)
    with tempfile.TemporaryDirectory() as data, \
            tempfile.TemporaryDirectory() as out:
        names, index = write_test_set(torch, data)
        t0 = time.time()
        res = run_children('inference', MH_HOSTS, [
            '--data_dir', data, '--name_idx', index, '--output_dir', out,
            '--mode', 'design', '--num_t', str(MH_NUM_T), '--num_samples',
            str(MH_SAMPLES), '--batch_samples', str(MH_SAMPLES), '--bf16',
            '--model_config', MODEL_CONFIG, '--seed', '0', '--device',
            'cuda'])
        wall = time.time() - t0
        owned = [set(x['names']) for x in res]
        if owned[0] & owned[1] or owned[0] | owned[1] != set(names):
            fail(f'multi-host: hosts took {owned}, expected a disjoint '
                 f'cover of {names}')
        design = os.path.join(out, 'design')
        want = sorted(['reference'] + [f'{i:04d}' for i in range(
            MH_SAMPLES)])
        if sorted(os.listdir(design)) != want:
            fail(f'multi-host: {sorted(os.listdir(design))}')
        for sub in want:
            files = sorted(os.listdir(os.path.join(design, sub)))
            if files != sorted(f'{n}.pdb' for n in names):
                fail(f'multi-host: {sub} holds {files}')
            for n in names:
                check_pdb(os.path.join(design, sub, f'{n}.pdb'), chains_of(n))
    for h, x in enumerate(res):
        if len(x['names']) != 1:
            fail(f'multi-host: host {h} took {x["names"]}')
        check_launches(x['launches'], passes_launches(PER_PASS, passes),
                       f'multi-host inference (host {h})')
    print(f'multi-host inference ({MH_HOSTS} hosts on one card, gloo, bf16, '
          f'num_t {MH_NUM_T}, {MH_SAMPLES} samples of one complex each) on '
          f'{card}: hosts {[x["names"] for x in res]}, sampling '
          f'{[round(x["sampling_s"], 2) for x in res]} s, wall '
          f'{[round(x["wall_s"], 2) for x in res]} s incl. model build; '
          f'children {wall:.1f} s', flush=True)
    return add_counts([x['launches'] for x in res]), {
        'children_s': wall, 'hosts': [x['names'] for x in res],
        'sampling_s': [x['sampling_s'] for x in res]}


def dp_setup(torch, mesh):
    """The data-parallel training case: f32 full width, dense random trunk
    weights (scale 0.5, seed 0), a frozen ESM2-3B with random weights made
    on the card, TrainConfig with the learning rate at its peak (1e-2:
    an update of 1e-4 of it stays above the f32 spacing of weights up to
    ~8) from the first update; the global batch of both test complexes,
    twice."""
    import random
    from abx_tpu_torch.cli import runner
    from abx_tpu_torch.data import dataset as ds
    from abx_tpu_torch.train.trainer import TrainConfig, Trainer
    from abx_tpu_torch.utils import params as params_lib
    rt = runner.build_runtime(MODEL_CONFIG, seed=0, device='cuda',
                              esm_random=True)
    params_lib.load_flax_params(rt.model, params_lib.dense_random_tree(
        params_lib.state_dict_tree(rt.model), seed=0, scale=0.5))
    trainer = Trainer(rt.model, rt.diffuser, rt.config.model, rt.config.loss,
                      TrainConfig(learning_rate=1e-2, warmup_steps=0,
                                  decay_steps=100, log_every=0),
                      esm=rt.esm, mesh=mesh)
    exs = []
    for i, pdb in enumerate(TEST_SET * (DP_BATCH // len(TEST_SET))):
        name = os.path.basename(pdb)[:-4]
        parts = name.split('_')
        ex = ds.complex_from_pdb(pdb, parts[1], parts[2], parts[3].split('|'))
        exs.append(ds.prepare_example(ex, rt.data_config, True,
                                      rng=random.Random(i))[0])
    return trainer, ds.stack_batch(exs)


def train_snapshot(trainer):
    return ({k: p.detach().cpu().clone() for k, p in trainer._params().items()},
            {k: p.grad.detach().cpu().clone()
             for k, p in trainer._params().items() if p.grad is not None})


def child_dp_train(torch, rank, world, port, args):
    """13d, one rank: two data-parallel steps on its rows of the global
    batch; rank 0 saves the weights and summed gradients after the first."""
    import torch.distributed as dist
    from abx_tpu_torch.parallel import mesh as mesh_lib
    child_join(rank, world, port)
    mesh = mesh_lib.make_mesh(device='cuda')
    trainer, batch = dp_setup(torch, mesh)
    state = trainer.init_state()
    mine = mesh_lib.shard_batch(mesh, batch)
    gen = torch.Generator(device='cuda').manual_seed(0)
    ws = wrappers()
    torch.cuda.synchronize()
    reset_counts(ws)
    times, metrics = [], []
    for i in range(2):
        t0 = time.time()
        m = trainer.step(state, mine, gen)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        metrics.append({k: float(m[k]) for k in ('total', 'grad_norm',
                                                  'num_recycle')})
        if i == 0 and rank == 0:
            torch.save(train_snapshot(trainer), args[0])
    launches = read_counts(ws)
    dist.barrier()
    dist.destroy_process_group()
    return {'metrics': metrics, 'step_s': times, 'launches': launches,
            'peak_gb': torch.cuda.max_memory_allocated() / 1e9}


def phase_dp_train(torch, card):
    """13d: one data-parallel step over DP_RANKS gloo ranks on the one card
    against one process's step on the whole batch."""
    from abx_tpu_torch.parallel import mesh as mesh_lib
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, 'dp_step1.pt')
        t0 = time.time()
        res = run_children('dp_train', DP_RANKS, [snap])
        wall = time.time() - t0
        w_dp, g_dp = torch.load(snap)
    trainer, batch = dp_setup(torch, mesh_lib.local_mesh('cuda'))
    state = trainer.init_state()
    w0 = {k: p.detach().cpu().clone() for k, p in trainer._params().items()}
    m = trainer.step(state, batch, torch.Generator(device='cuda')
                     .manual_seed(0))
    torch.cuda.synchronize()
    w1, g1 = train_snapshot(trainer)
    loss, norm1 = float(m['total']), float(m['grad_norm'])
    lr, trainer_clip = trainer.config.learning_rate, trainer.config.grad_clip
    del trainer, state
    torch.cuda.empty_cache()
    dp_loss, dp_norm = (res[0]['metrics'][0][k] for k in ('total',
                                                          'grad_norm'))
    loss_rel = abs(dp_loss - loss) / abs(loss)
    max_dw = max((w1[k] - w0[k]).abs().max().item() for k in w1)
    g_err = max((g_dp[k] - g1[k]).abs().max().item() for k in g1)
    g_max = max(g.abs().max().item() for g in g1.values())
    def first_update(g, norm):
        g = g if norm < trainer_clip else g / norm * trainer_clip
        return g / (g.abs() + ADAM_EPS)
    bar = DP_WEIGHT_TOL * max_dw
    bad, noisy, total, err_max = 0, 0, 0, 0.0
    for k in w1:
        err = (w_dp[k] - w1[k]).abs()
        zero = torch.zeros_like(w1[k])
        du = (first_update(g_dp.get(k, zero), dp_norm)
              - first_update(g1.get(k, zero), norm1)).abs() * lr
        held = du <= HELD_SHARE_OF_BAR * bar
        noisy += int((~held).sum())
        bad += int((err[held] > bar).sum())
        if bool(held.any()):
            err_max = max(err_max, float(err[held].max()))
        total += err.numel()
    step_s = statistics.median(x['step_s'][1] for x in res)
    print(f'data-parallel training ({DP_RANKS} gloo ranks on one card, f32, '
          f'global batch {DP_BATCH}, full width, ESM2-3B frozen) on {card}: '
          f'loss {dp_loss:.7g} vs one process {loss:.7g} (rel '
          f'{loss_rel:.3g}); gradients max |diff| {g_err:.3g} (max '
          f'{g_max:.3g}); weights after the update max |diff| {err_max:.3g} '
          f'against max |update| {max_dw:.3g} on the {total - noisy} '
          f'weights whose first Adam update the two runs\' gradients '
          f'determine to a tenth of the bar ({noisy} of {total} not); '
          f'{step_s:.3f} s per step (the second step, '
          f'median over ranks; steps {[x["step_s"] for x in res]}); peak '
          f'{[round(x["peak_gb"], 2) for x in res]} GB; children '
          f'{wall:.1f} s', flush=True)
    if loss_rel > DP_LOSS_TOL:
        fail(f'dp train: loss {dp_loss} vs {loss}')
    if g_err > DP_GRAD_TOL * g_max:
        fail(f'dp train: gradients differ by {g_err:.3g} (max {g_max:.3g})')
    if bad:
        fail(f'dp train: {bad} weights beyond {DP_WEIGHT_TOL} x max|update|')
    for r, x in enumerate(res):
        passes = sum(int(mm['num_recycle']) + 1 for mm in x['metrics'])
        check_launches(x['launches'], {'esm_attention': ESM_LAYERS * passes},
                       f'dp train (rank {r})')
        if x['metrics'] != res[0]['metrics']:
            fail(f'dp train: rank {r} metrics {x["metrics"]}')
    return add_counts([x['launches'] for x in res]), {
        'loss_rel': loss_rel, 'grad_max_abs_err': g_err, 'grad_max': g_max,
        'weight_max_abs_err': err_max, 'max_update': max_dw,
        'weights_not_held': noisy, 'weights': total, 's_per_step': step_s,
        'children_s': wall, 'peak_gb': [x['peak_gb'] for x in res]}


def phase_13(torch, card):
    """Phase 13; returns its paths' launches and its stats."""
    t0 = time.time()
    paths, stats = phase_picard(torch, card)
    paths['tp_esm'], stats['tp_esm'] = phase_tp_esm(torch, card)
    paths['multihost_inference'], stats['multihost_inference'] = \
        phase_multihost(torch, card)
    paths['dp_train'], stats['dp_train'] = phase_dp_train(torch, card)
    paths['trace'], stats['trace'] = phase_trace(torch, card)
    stats['seconds'] = time.time() - t0
    print(f'phase 13 took {stats["seconds"]:.1f} s', flush=True)
    return paths, stats


CHILDREN = {'tp_esm': child_tp_esm, 'inference': child_inference,
            'dp_train': child_dp_train}


REF_NUM_T = 4


def phase_reference_ckpt(torch, card):
    """Phase 14: the design CLI from a reference-format `.ckpt` against the
    same weights from the port's `params.pt`, bit for bit."""
    from abx_tpu_torch.cli import design, runner
    from abx_tpu_torch.utils import checkpoint as ckpt_lib
    from abx_tpu_torch.utils import torch_convert
    t0 = time.time()
    rt = runner.build_runtime(MODEL_CONFIG, seed=0, bf16=True, device='cuda')
    g = torch.Generator().manual_seed(14)
    with torch.no_grad():
        for p in rt.model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g).to(p))
    ws = wrappers()
    passes = (REF_NUM_T + 1) * (NUM_RECYCLE + 1)
    expected = {k: n * passes for k, n in PER_PASS.items()}
    with tempfile.TemporaryDirectory() as tmp:
        files = {'reference': os.path.join(tmp, 'abx_diffab.ckpt'),
                 'port': os.path.join(tmp, 'params.pt')}
        torch.save({'model_state_dict':
                    torch_convert.reference_state_dict(rt.model)},
                   files['reference'])
        ckpt_lib.save_params(files['port'], rt.model.state_dict())
        del rt
        texts, launches, seconds = {}, None, {}
        for kind, path in files.items():
            out = os.path.join(tmp, kind)
            argv = ['--pdb_file', PDB, '--output_dir', out, '--model_config',
                    MODEL_CONFIG, '--model', path, '--seed', '0', '--bf16',
                    '--device', 'cuda', '--num_samples', str(NUM_SAMPLES),
                    '--batch_samples', str(NUM_SAMPLES), '--num_t',
                    str(REF_NUM_T)]
            reset_counts(ws)
            t1 = time.time()
            design.main(argv)
            torch.cuda.synchronize()
            seconds[kind] = time.time() - t1
            if kind == 'reference':
                launches = read_counts(ws)
            texts[kind] = {}
            for i in range(NUM_SAMPLES):
                pdb = os.path.join(out, 'design', f'{i:04d}',
                                   '6ct7_H_L_S.pdb')
                if not os.path.exists(pdb):
                    fail(f'phase 14: the {kind} run wrote no {pdb}')
                check_pdb(pdb)
                with open(pdb, encoding='utf-8') as f:
                    texts[kind][i] = f.read()
        for i in range(NUM_SAMPLES):
            if texts['reference'][i] != texts['port'][i]:
                diff = [(a, b) for a, b in zip(
                    texts['reference'][i].splitlines(),
                    texts['port'][i].splitlines()) if a != b]
                fail(f'phase 14: design {i} from the reference .ckpt differs '
                     f'from the same weights loaded from params.pt on '
                     f'{len(diff)} lines, first {diff[:1]}')
    check_launches(launches, expected, 'reference-checkpoint design')
    total = time.time() - t0
    print(f'phase 14 (reference .ckpt vs params.pt, bf16, num_t '
          f'{REF_NUM_T}) on {card}: {NUM_SAMPLES} designs bit-identical; '
          f'design CLI {seconds["reference"]:.2f} s (.ckpt) / '
          f'{seconds["port"]:.2f} s (params.pt); phase {total:.1f} s',
          flush=True)
    return launches, {'seconds': total, 'design_s': seconds,
                      'identical': NUM_SAMPLES}


# Phase 15: the quality and rehearsal tools of abx_tpu_torch/tools at full
# width and small depth.  The overfit evaluation's sampler options, as
# (num_t, ESM passes a grid position: 3 inside every trunk pass, or 1 at
# every refresh-th position with ESM reuse, refresh interval): the base
# evaluation, esm_reuse, esm_refresh_k2, corrector_t4_off / _k2 and
# fast_recipe_t25.
TOOL_NUM_T, TOOL_ESM_LAYERS = 8, 6
TOOL_EVALS = [(TOOL_NUM_T, 3, 1), (TOOL_NUM_T, 1, 1), (TOOL_NUM_T, 1, 2),
              (4, 3, 1), (4, 3, 1), (25, 1, 8)]


def tool_eval_launches(evals, dtypes=2):
    """Launches of a set of evaluations, in each dtype: the trunk rows per
    pass x 3 passes a grid position (the prime step + num_t), and for each
    ESM pass esm_attention once a layer and esm_layer_norm once a
    LayerNorm."""
    passes = esm = 0
    for num_t, esm_per_pos, refresh in evals:
        grid = num_t + 1
        passes += grid * (NUM_RECYCLE + 1)
        esm += (grid * esm_per_pos if esm_per_pos > 1
                else len(range(0, grid, refresh)))
    return {**passes_launches(PER_PASS, passes * dtypes),
            'esm_attention': esm * TOOL_ESM_LAYERS * dtypes,
            'esm_layer_norm': esm_ln_launches(TOOL_ESM_LAYERS, esm * dtypes)}


def finite(x):
    return x is not None and math.isfinite(x)


def phase_tools(torch, card):
    """Phase 15: the rehearsal (train CLI subprocesses, SIGKILL, resume,
    held-out evaluation), the overfit tool's evaluation flags, both routes
    of the revalidation tool and the Picard probe."""
    from abx_tpu_torch.tools import (multi_train_rehearsal, overfit_6ct7,
                                     probe_picard, revalidate_kernels)
    ws = wrappers()
    paths, stats = {}, {}
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        # 15a: 8 steps of B = 4, a checkpoint every 2, killed after the one
        # at step 4; the holdout's 4 CDR designs at num_t 4 in this process.
        reset_counts(ws)
        t0 = time.time()
        res = multi_train_rehearsal.main([
            '--steps', '8', '--checkpoint_every', '2', '--batch', '4',
            '--num_t', '4', '--num_samples', '4',
            '--out', os.path.join(tmp, 'mt'),
            '--work', os.path.join(tmp, 'mt_work')])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = read_counts(ws)
        events = {e['event']: e for e in res['timeline']}
        if events.get('sigkill', {}).get('checkpoint_step') != 4 or \
                'resume_done' not in events:
            fail(f'rehearsal timeline: {res["timeline"]}')
        if res['last_step'] != 8:
            fail(f'rehearsal: metrics.csv ends at step {res["last_step"]}')
        ev = res['holdout_eval']
        if len(ev['samples']) != 4 or not all(
                finite(r['cdr_rmsd']) for r in ev['samples']):
            fail(f'rehearsal holdout evaluation: {ev["samples"]}')
        check_launches(launches, passes_launches(PER_PASS, 5 * 3),
                       'rehearsal holdout evaluation')
        paths['tools_rehearsal'] = launches
        stats['rehearsal'] = {
            'seconds': seconds, 's_per_step_rows': res['s_per_step_rows'],
            'peak_memory_gb_resumed_run': res['peak_memory_gb_resumed_run'],
            'sigkill_after_rows': events['sigkill']['after_metric_rows'],
            'cdr_rmsd_mean': ev['cdr_rmsd_mean']}
        print(f'phase 15a, rehearsal (16 complexes, B=4, 8 steps, SIGKILL '
              f'after the step-4 checkpoint, resume) on {card}: '
              f'{seconds:.1f} s; s a step by metric row '
              f'{[round(x, 3) for x in res["s_per_step_rows"]]}; holdout '
              f'CDR RMSD {ev["cdr_rmsd_mean"]:.2f} A', flush=True)

        # 15b: 2 overfit steps with a frozen random ESM2, then every
        # evaluation flag on those weights (the launches counted there).
        of = os.path.join(tmp, 'overfit')
        base = ['--esm_random', '--esm_layers', str(TOOL_ESM_LAYERS),
                '--num_t', str(TOOL_NUM_T), '--num_samples', '4',
                '--out', of]
        t0 = time.time()
        overfit_6ct7.main(['--steps', '2'] + base)
        reset_counts(ws)
        t1 = time.time()
        result = overfit_6ct7.main(base + [
            '--eval_only', '--eval_esm_reuse', '--eval_esm_refresh', '2',
            '--eval_corrector', '4', '--eval_fast_recipe'])
        torch.cuda.synchronize()
        launches = read_counts(ws)
        keys = ['esm_reuse', 'esm_refresh_k2', 'corrector_t4_off',
                'corrector_t4_k2', 'fast_recipe_t25']
        for key in ['eval'] + keys:
            for dtype in ('f32', 'bf16'):
                block = result.get(key, {}).get(dtype)
                if not block or block['n'] != 4 or not (
                        finite(block['h3_rmsd_mean'])
                        and finite(block['h3_rmsd_ci95'])
                        and finite(block['h3_aar_mean'])):
                    fail(f'overfit tool: result[{key!r}][{dtype!r}] = '
                         f'{block}')
        check_launches(launches, tool_eval_launches(TOOL_EVALS),
                       'overfit evaluation flags')
        paths['tools_overfit_eval'] = launches
        stats['overfit_eval_flags'] = {
            'train_and_eval_s': t1 - t0, 'eval_flags_s': time.time() - t1,
            **{k: {d: result[k][d]['h3_rmsd_mean'] for d in ('f32', 'bf16')}
               for k in keys}}
        print(f'phase 15b, overfit tool (2 steps, ESM2 {TOOL_ESM_LAYERS} x '
              f'320 random) on {card}: every --eval_* key in both dtypes, '
              f'{time.time() - t1:.1f} s for the evaluations', flush=True)

        # 15c: the revalidation tool on those weights, on the default route
        # and on the plain route (every kernel flag 0, ESM attention too;
        # ESM2's LayerNorm has no flag and launches on both).
        verdicts = {}
        for route, env in (('kernels', {}),
                           ('plain', {**{k: '0' for k in ALL_FLAGS},
                                      'ABX_FUSED_ESM_ATTN': '0'})):
            set_flags(env)
            reset_counts(ws)
            rc = revalidate_kernels.main([
                '--run_dir', of, '--num_t', str(TOOL_NUM_T),
                '--num_samples', '4', '--tag', route])
            launches = read_counts(ws)
            set_flags({})
            os.environ.pop('ABX_FUSED_ESM_ATTN', None)
            with open(os.path.join(of, f'bf16_kernel_eval_{route}.json'),
                      encoding='utf-8') as f:
                rec = json.load(f)
            if rc not in (0, 1) or len(rec['abs_delta_per_sample']) != 4 \
                    or not finite(rec['max_per_sample_delta']):
                fail(f'revalidation ({route}): rc {rc}, {rec}')
            expected = tool_eval_launches(TOOL_EVALS[:1], dtypes=1)
            if route == 'plain':
                expected = {'esm_layer_norm': expected['esm_layer_norm']}
            check_launches(launches, expected, f'revalidation ({route})')
            paths[f'tools_revalidate_{route}'] = launches
            verdicts[route] = {'quality': rec['quality'],
                               'max_per_sample_delta':
                                   rec['max_per_sample_delta']}
        stats['revalidate'] = verdicts
        print(f'phase 15c, revalidation (2-step weights, plumbing only) on '
              f'{card}: {verdicts}', flush=True)

        # 15d: the Picard probe at num_t 4 (B = 1, bf16).
        reset_counts(ws)
        t0 = time.time()
        pic = probe_picard.main(['--num_t', '4',
                                 '--out', os.path.join(tmp, 'picard')])
        seconds = time.time() - t0
        launches = read_counts(ws)
        e = pic['configs']['t4']
        for tol in ('tol0', 'tol1e-4'):
            if 'error' in e[tol] or e[tol]['sweeps'] > e[tol]['grid_len']:
                fail(f'picard probe {tol}: {e[tol]}')
        if not e['tol0']['seq_matches_sequential'] or \
                e['tol0']['atom14_max_dev_A'] > BB_TOL:
            fail(f'picard probe: the fixpoint differs from the sequential '
                 f'run: {e["tol0"]}')
        # Three sequential runs (cold, warm, the tol-0 check) of the whole
        # grid, and a cold and a warm Picard run at each tolerance, each
        # sweep one pass of every grid position's rows.
        passes = (NUM_RECYCLE + 1) * (
            3 * e['tol0']['grid_len']
            + 2 * (e['tol0']['sweeps'] + e['tol1e-4']['sweeps']))
        check_launches(launches, passes_launches(PER_PASS, passes),
                       'picard probe')
        paths['tools_picard_probe'] = launches
        stats['picard_probe'] = {'seconds': seconds, **e}
        print(f'phase 15d, Picard probe (B=1, num_t 4, bf16) on {card}: '
              f'{seconds:.1f} s, sweeps {e["tol0"]["sweeps"]} / grid '
              f'{e["tol0"]["grid_len"]}, backbone vs sequential '
              f'{e["tol0"]["atom14_max_dev_A"]:.3g} A', flush=True)
    stats['seconds'] = time.time() - t_phase
    print(f'phase 15 in {stats["seconds"]:.1f} s', flush=True)
    return paths, stats


def child_main(argv):
    """`chip_smoke.py --child <kind> <rank> <world> <port> [args]`: one
    process of phase 13 on the card; prints one result line."""
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail('child: no CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from abx_tpu_torch.ops import _lib
    _lib.lib()
    kind, rank, world, port = argv[0], int(argv[1]), int(argv[2]), \
        int(argv[3])
    out = CHILDREN[kind](torch, rank, world, port, argv[4:])
    print(CHILD_TAG + json.dumps(out), flush=True)


def main():
    if not os.path.isdir(os.path.join(HERE, 'abx_tpu_torch')):
        fail('abx_tpu_torch/ not found beside chip_smoke.py: run it from a '
             'checkout of the repository')
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    card = card_line()
    print(f'device: {torch.cuda.get_device_name(0)}, count '
          f'{torch.cuda.device_count()}, torch {torch.__version__}, CUDA '
          f'{torch.version.cuda}; card: {card}', flush=True)

    from abx_tpu_torch.ops import _lib
    t0 = time.time()
    path = _lib.build()
    _lib.lib()
    print(f'kernels built and loaded in {time.time() - t0:.1f} s: {path}',
          flush=True)

    one_tile = phase_one_tile(torch, dev)
    kernels = phase_kernels(torch, dev)
    exponent = phase_exponent(torch, dev)
    rounding = phase_rounding_points(torch, dev)
    ipa_cancel = phase_ipa_cancel(torch, dev)
    contraction = phase_contraction(torch, dev)
    flags = phase_flags(torch, dev)
    esm_flags = phase_esm_flags(torch, dev)
    paths, stats = {}, {}
    design_out = tempfile.mkdtemp(prefix='chip_smoke_design_')
    paths['design_esm_off'], stats['design'] = phase_design(
        torch, card, keep=design_out)
    paths['design_esm_on'], stats['design_esm'], rt_esm, complexes = \
        phase_design_esm(torch, card)
    paths['design_esm_reuse'], stats['design_esm_reuse'] = \
        phase_design_esm_reuse(torch, card, rt_esm, complexes)
    paths['design_esm_flash'], stats['design_esm_flash'] = \
        phase_design_esm_flash(torch, card, rt_esm, complexes)
    print(f'ESM-on design s per step: flash route '
          f'{stats["design_esm_flash"]["s_per_step"]:.3f}, esm_attention '
          f'{stats["design_esm"]["s_per_step"]:.3f} (first trajectory), '
          f'{stats["design_esm"]["steady_s_per_step"]:.3f} (second)',
          flush=True)
    from abx_tpu_torch.cli import runner
    rt_off = runner.build_runtime(MODEL_CONFIG, seed=0, bf16=True,
                                  device='cuda')
    paths['resumable'], stats['resumable'] = phase_resumable(torch, rt_off)
    stats['bench_smoke'] = phase_bench(torch, rt_off, rt_esm)
    del rt_esm, rt_off, complexes
    torch.cuda.empty_cache()
    paths['optimize_opt_in'], stats['optimize_opt_in'] = phase_optimize(
        torch, card)
    paths['trajectory'] = phase_trajectory(torch)
    paths['design_c_major'], stats['design_c_major'] = phase_design(
        torch, card, C_MAJOR, C_MAJOR_PER_PASS, 'design (ABX_TRIMULT_C_MAJOR)')
    paths['design_seqres'], stats['design_seqres'] = phase_seqres(torch, card)
    eval_paths, stats['eval'] = phase_eval(torch, card, design_out)
    paths.update(eval_paths)
    shutil.rmtree(design_out)
    train_paths, stats['train'] = phase_train(torch, card)
    paths.update(train_paths)
    p13_paths, stats['phase13'] = phase_13(torch, card)
    paths.update(p13_paths)
    paths['design_reference_ckpt'], stats['reference_ckpt'] = \
        phase_reference_ckpt(torch, card)
    tool_paths, stats['tools'] = phase_tools(torch, card)
    paths.update(tool_paths)

    rows = []
    for name, (source, replaces) in KERNEL_META.items():
        cases = kernels[name]['cases']
        first = cases[0]
        by_path = {p: counts.get(name, 0) for p, counts in paths.items()}
        rows.append({
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': max(by_path.values()),
            'launches_by_path': by_path,
            'max_abs_err': max(c['max_abs_err'] for c in cases),
            'ms': first['ms'], 'plain_ms': first['plain_ms'],
            'bound_ms': first['bound_ms'], 'bound_by': first['bound_by'],
            'library_ms': first['library_ms'], 'cases': cases,
            **{k: v for k, v in kernels[name].items() if k != 'cases'}})
    print(card)
    print(json.dumps({'kernels': rows, 'bf16_exp_final_max': exponent,
                      'bf16_rounding_points': rounding,
                      'post_c_major_one_tile': one_tile,
                      'ipa_scalar_attend_bf16_p': ipa_cancel,
                      'flags_vs_off': flags,
                      'esm_flags_on_vs_off': esm_flags,
                      'contraction': contraction, **stats}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    if sys.argv[1:2] == ['--child']:
        child_main(sys.argv[2:])
    else:
        main()
