"""What the correctness check needs of the timed path, taken while it runs.

For each step drawn for the check: the step's input state, the generator
state its random draws start from, the recycled sequence and binned
positions that each later recycling pass reads, the final pass's logits,
predicted frames and scores, the first pass's ESM2 embedding, and the
next state the step returns; and the t = 1 start of the window's first
trajectory.  Forward hooks on the program's modules read them (no file
of the program is changed), and copies to pinned host buffers on a side
stream take them off the card without a synchronisation, so the check
adds no wait and no device memory to the window.  The buffers are
allocated during set-up.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch


class _Copier:
    """Copies device tensors into host buffers, asynchronously on a side
    stream of the card (plainly on the CPU)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == 'cuda'
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def buffer_like(self, t: torch.Tensor) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=self.cuda)

    def copy(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        if not self.cuda:
            dst.copy_(src)
            return
        self.stream.wait_stream(torch.cuda.current_stream(src.device))
        with torch.cuda.stream(self.stream):
            dst.copy_(src, non_blocking=True)
        src.record_stream(self.stream)

    def finish(self) -> None:
        if self.cuda:
            self.stream.synchronize()


class StepRecord:
    """Host copies of one checked step."""

    def __init__(self):
        self.index = -1          # global step index in the window
        self.position = -1       # grid position in its trajectory
        self.generator_state: Optional[torch.Tensor] = None
        self.bufs: Dict[str, torch.Tensor] = {}
        self.forced: List[Optional[Dict[str, str]]] = []

    def get(self, key: str) -> torch.Tensor:
        return self.bufs[key]


class Capture:
    """Hooks for the checked steps of the window.

    `model` is the program's score network (one call a recycling pass) and
    `esm` its ESM2 module or None; `steps` the global step indices to
    record.  Call `start(prepared)` with the first trajectory's prepared
    batch, `before(...)` and `after(...)` around every step."""

    STATE = ('rigids_t', 'seq_t', 'prev_pos', 'prev_seq', 'prev_pair')

    def __init__(self, model, esm, steps, device, num_passes: int):
        self.model, self.esm = model, esm
        self.steps = sorted(steps)
        self.num_passes = num_passes
        self.copier = _Copier(torch.device(device))
        self.records: Dict[int, StepRecord] = {}
        self.start_bufs: Dict[str, torch.Tensor] = {}
        self._pool: List[StepRecord] = []
        self._cur: Optional[StepRecord] = None
        self._pass = 0
        self._handles = []

    # -- buffers -----------------------------------------------------------
    def _buf(self, rec: StepRecord, key: str, t: torch.Tensor) -> None:
        if key not in rec.bufs:
            rec.bufs[key] = self.copier.buffer_like(t)
        self.copier.copy(t, rec.bufs[key])

    def allocate(self, rec_template: StepRecord) -> None:
        """Give every checked step host buffers shaped as those of
        `rec_template` (a step recorded during the warm-up, whose buffers
        serve the first)."""
        self._pool = [rec_template]
        for _ in self.steps[1:]:
            rec = StepRecord()
            rec.bufs = {k: self.copier.buffer_like(v)
                        for k, v in rec_template.bufs.items()}
            self._pool.append(rec)

    # -- the window --------------------------------------------------------
    def start(self, prepared: Dict[str, torch.Tensor]) -> None:
        for k in ('rigids_t', 'seq_t'):
            if k not in self.start_bufs:
                self.start_bufs[k] = self.copier.buffer_like(prepared[k])
            self.copier.copy(prepared[k], self.start_bufs[k])

    def before(self, index: int, position: int, state, generator,
               force: bool = False) -> None:
        if index not in self.steps and not force:
            return
        rec = self._pool.pop(0) if self._pool else StepRecord()
        rec.index, rec.position = index, position
        rec.generator_state = generator.get_state()
        for k in self.STATE:
            self._buf(rec, 'in.' + k, state[k])
        rec.forced = [None] * self.num_passes
        self._cur, self._pass = rec, 0
        self._handles = [
            self.model.register_forward_pre_hook(self._pre_pass),
            self.model.register_forward_hook(self._post_pass)]
        if self.esm is not None:
            self._handles.append(self.esm.register_forward_hook(self._esm))

    def after(self, new_state) -> Optional[StepRecord]:
        rec = self._cur
        if rec is None:
            return None
        for h in self._handles:
            h.remove()
        self._handles = []
        for k in ('rigids_t', 'seq_t'):
            self._buf(rec, 'out.' + k, new_state[k])
        self.records[rec.index] = rec
        self._cur = None
        return rec

    def finish(self) -> None:
        self.copier.finish()

    # -- hooks ---------------------------------------------------------------
    def _pre_pass(self, module, args):
        rec, p = self._cur, self._pass
        if p:
            batch = args[0]
            self._buf(rec, f'pass{p}.seq_t', batch['seq_t'])
            self._buf(rec, f'pass{p}.prev_pos', batch['prev_pos'])
            rec.forced[p] = {'seq_t': f'pass{p}.seq_t',
                             'prev_pos': f'pass{p}.prev_pos'}

    def _post_pass(self, module, args, output):
        self._pass += 1
        if self._pass == self.num_passes:
            heads = output['heads']
            self._buf(self._cur, 'logits',
                      heads['sequence_module']['logits'])
            self._buf(self._cur, 'rot_score', heads['folding']['rot_score'])
            self._buf(self._cur, 'trans_score',
                      heads['folding']['trans_score'])
            self._buf(self._cur, 'frames', heads['folding']['rigids'])

    def _esm(self, module, args, output):
        if self._pass == 0:
            self._buf(self._cur, 'esm', output)
