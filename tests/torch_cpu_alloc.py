"""Keep freed tensor memory in the process while a CPU test runs.

glibc serves every allocation past its mmap threshold with a fresh mmap and
unmaps it on free, so each trunk pass of the tiny model at L = 288 (whose
(L, L)-sized activations run to hundreds of MB) page-faults its memory in
anew: about half the CPU time of such a test on one thread is the kernel's.
`retain_freed_memory` turns that off (no mmap, no trimming) for as long as
it is entered and hands the memory back at its end; `SUBPROCESS_ENV` does
the same for a child process through glibc's environment tunables.
`lean_cpu` adds one torch thread, which costs such a run the least CPU
time (or a few: a run that scales well on two costs little more CPU time
and half the wall time).
"""

import contextlib
import ctypes
import os

M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4       # glibc's mallopt parameters
DEFAULT_TRIM_THRESHOLD, DEFAULT_MMAP_MAX = 128 * 1024, 65536
NO_TRIM = 2 ** 31 - 1
SUBPROCESS_ENV = {'MALLOC_MMAP_MAX_': '0',
                  'MALLOC_TRIM_THRESHOLD_': str(NO_TRIM)}


@contextlib.contextmanager
def retain_freed_memory():
    try:
        libc = ctypes.CDLL('libc.so.6')
        mallopt, trim = libc.mallopt, libc.malloc_trim
    except (OSError, AttributeError):   # not glibc: nothing to tune
        yield
        return
    mallopt(M_MMAP_MAX, 0)
    mallopt(M_TRIM_THRESHOLD, NO_TRIM)
    try:
        yield
    finally:
        mallopt(M_MMAP_MAX, DEFAULT_MMAP_MAX)
        mallopt(M_TRIM_THRESHOLD, DEFAULT_TRIM_THRESHOLD)
        trim(0)


@contextlib.contextmanager
def lean_cpu(children: bool = False, threads: int = 1):
    """`threads` torch threads and freed memory kept, in this process and,
    with `children`, in the child processes it starts while entered."""
    import torch
    n = torch.get_num_threads()
    env = ({'OMP_NUM_THREADS': str(threads), **SUBPROCESS_ENV} if children
           else {})
    saved = {k: os.environ.get(k) for k in env}
    torch.set_num_threads(threads)
    os.environ.update(env)
    try:
        with retain_freed_memory():
            yield
    finally:
        torch.set_num_threads(n)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
