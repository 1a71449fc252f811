"""Selective rematerialisation: the port's counterpart of the JAX package's
``nn.remat(block, policy=save_only_these_names("attn_out"))``.

``checkpoint(fn, *args, generator=None)`` runs one block under
``torch.utils.checkpoint`` (non-reentrant). Autograd then keeps the block's
inputs and, on the block's tape, every attention output the block produced;
the backward recomputes the rest of the block (LayerNorms, projections, MLP)
from the inputs before it differentiates it.

The tape: each attention ``autograd.Function`` of ``ops`` (kernels 2, 5, 6
and 8 in their forwards, and TimeSformer's nt spatial attention) computes its
output through ``saved_output``. While a checkpointed block runs forward, that
records the output (and kernel 2's log-sum-exp rows); while the backward
recomputes the block, it hands the recorded tensors back in the same order
instead of running the attention again. The Function still saves what its
backward reads, so the backward kernels (3-4, 7, 9) run as without remat.
Outside a checkpointed block ``saved_output`` just computes.

``generator``: a ``torch.Generator`` the block draws from (Swin3D's drop
path). ``torch.utils.checkpoint`` restores only the global RNG states, so
the recompute runs with this generator set back to its state at the block's
start, and puts it back after, so the recompute draws the masks the forward
drew.

With the ``plain`` attention impl there is no Function, and the recompute
runs the plain attention again, as a remat without a policy would.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import torch
import torch.utils.checkpoint

_local = threading.local()


class _Tape:
    """The attention outputs of one checkpointed block, in call order;
    ``pos`` is None while recording, else the next one to hand back."""

    def __init__(self):
        self.saved = []
        self.pos: Optional[int] = None


def _detach(out):
    if isinstance(out, tuple):
        return tuple(x.detach() for x in out)
    return out.detach()


def saved_output(compute: Callable, *args):
    """``compute(*args)`` (a tensor or a tuple of tensors), recorded on the
    tape of the checkpointed block being run, or handed back from it while
    that block is recomputed."""
    tape = getattr(_local, "tape", None)
    if tape is None:
        return compute(*args)
    if tape.pos is None:
        out = compute(*args)
        tape.saved.append(_detach(out))
        return out
    out = tape.saved[tape.pos]
    tape.pos += 1
    return _detach(out)


class _Recording:
    """The forward's context: attention outputs go onto ``tape``."""

    def __init__(self, tape: _Tape):
        self.tape = tape

    def __enter__(self):
        self.outer = getattr(_local, "tape", None)
        _local.tape, self.tape.pos = self.tape, None

    def __exit__(self, *exc):
        _local.tape = self.outer


class _Replaying(_Recording):
    """The recompute's context (entered once per backward that needs it):
    attention outputs come off ``tape`` from its start, and ``generator``
    runs from ``start_state``, then goes back to where it was."""

    def __init__(self, tape: _Tape, generator: Optional[torch.Generator], start_state):
        super().__init__(tape)
        self.generator, self.start_state = generator, start_state

    def __enter__(self):
        self.outer = getattr(_local, "tape", None)
        _local.tape, self.tape.pos = self.tape, 0
        if self.generator is not None:
            self.now = self.generator.get_state()
            self.generator.set_state(self.start_state)

    def __exit__(self, *exc):
        _local.tape = self.outer
        if self.generator is not None:
            self.generator.set_state(self.now)


def checkpoint(fn: Callable, *args, generator: Optional[torch.Generator] = None):
    """``fn(*args)`` rematerialised in the backward, its attention outputs
    kept (see the module docstring)."""
    tape = _Tape()
    start_state = generator.get_state() if generator is not None else None
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (_Recording(tape), _Replaying(tape, generator, start_state)))
