"""Runtime sanitizer for engine dispatch paths, and the explicit transfer
points it polices.

Port of `openr_tpu.device.sanitizer`.  The reference wraps a dispatch in
``jax.transfer_guard("disallow")``; here a `TorchDispatchMode` sees every
aten op the block runs, on the CPU as on the card:

- :meth:`EngineSanitizer.transfer_guard` fails the block with
  :class:`SanitizerViolation` ("implicit ...") on

  * **host data reaching a dispatch outside the explicit staging.**  Every
    tensor made from host data (``torch.from_numpy``, ``torch.as_tensor``,
    ``torch.tensor``, a list or numpy index) passes through
    ``aten.lift_fresh``; the guard tags it there (a 0-dim tensor of a
    Python scalar, as in ``t[i] = 0``, is an argument, not host data).  A tagged tensor that an
    op consumes (on the CPU, where "device" is the host, any op; on the
    card, an op with a CUDA operand), a host-data tensor made directly on
    the card, or a CPU -> CUDA copy, is a violation unless it happens
    inside :func:`stage` — the one sanctioned upload, which the engine's
    ``_put`` and its indexed writes use and which is byte-counted where
    the engine counts it.
  * **a device -> host sync outside a declared fetch point.**
    ``aten._local_scalar_dense`` (``.item()``, ``bool(t)``, ``int(t)``,
    ``float(t)``, a branch on a tensor), ``aten.equal`` and
    ``aten.is_nonzero`` reach the mode on both devices; a CUDA -> CPU copy
    (``.cpu()``, ``.to("cpu")``) on the card.  A deliberate read goes
    through :func:`fetch` (a host copy) or :func:`fetch_point` (a block of
    reads), which name why; the guard lets those through and counts them
    per reason.  On the CPU, ``.cpu()``, ``.numpy()`` and ``.tolist()`` of
    a tensor reach no aten op that copies, so the static rule
    ``device-host-sync`` (analysis/dispatch.py) covers them there.

  A violation is recorded when it happens and raised when the block ends
  too, so a caller's broad ``except`` cannot swallow it.  Any other
  exception passes through with its own type.  The dispatch-mode stack is
  per thread: the guard sees the work of the thread that entered it.

- :meth:`EngineSanitizer.compile_budget` fails the block when the engine
  runs more than ``allowed`` ladder keys it had not run before (default
  0).  The port compiles no programs, but it keys every forward run
  ``spf_results`` makes (`DeviceResidencyEngine.cached_program_keys`,
  ``(topo, s_bucket, n_words, n_sweeps, small, use_link_metric)``): after
  warmup a steady-state query must land on a key already run, so a new
  key in the hot loop means the key leaked per-query state (a fresh sweep
  hint, an unpadded source count) — the regression the reference's
  compile budget exists to catch.

- :meth:`EngineSanitizer.sanitized` applies both.

The guard costs one Python call per aten op of the block; outside a guard
:func:`stage` and :func:`fetch` cost a thread-local read each.
"""

from __future__ import annotations

import threading
from collections import Counter
from contextlib import contextmanager
from typing import Iterator, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "EngineSanitizer",
    "SanitizerViolation",
    "fetch",
    "fetch_point",
    "stage",
]

# the attribute that marks a tensor made from host data inside a guard
_HOST_TAG = "_openr_host_data"

_aten = torch.ops.aten
# aten ops that read a device value on the host and wait for it
_SYNC_OPS = frozenset(
    (
        _aten._local_scalar_dense.default,
        _aten.equal.default,
        _aten.is_nonzero.default,
    )
)
_COPY_OPS = frozenset(
    (_aten._to_copy.default, _aten.copy_.default, _aten.copy.default)
)
_LIFT_OPS = frozenset((_aten.lift_fresh.default, _aten.lift_fresh_copy.default))


# dtypes stage() converts on the host before the upload
_NP_DTYPES = {
    torch.bool: np.bool_,
    torch.int16: np.int16,
    torch.int32: np.int32,
    torch.int64: np.int64,
    torch.float32: np.float32,
}


class SanitizerViolation(AssertionError):
    """An engine dispatch broke a runtime residency contract."""


class _Tls(threading.local):
    def __init__(self) -> None:
        # depth of stage() blocks on this thread
        self.staging = 0
        # reasons of the open fetch points on this thread, innermost last
        self.fetching: list = []
        # the innermost armed guard of this thread, None when unarmed
        self.guard: Optional["_GuardMode"] = None


_TLS = _Tls()


def staging_depth() -> int:
    """Open stage() blocks on this thread (the program auditor reads it)."""
    return _TLS.staging


def fetch_reason() -> Optional[str]:
    """The innermost open fetch point's reason on this thread, or None."""
    f = _TLS.fetching
    return f[-1] if f else None


class _Staging:
    __slots__ = ()

    def __enter__(self) -> None:
        _TLS.staging += 1

    def __exit__(self, *exc) -> None:
        _TLS.staging -= 1


_STAGING = _Staging()


def stage(
    a,
    device: torch.device,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The explicit host -> device upload: host data (a numpy array, a
    list, a scalar) copied onto `device` (a copy on the CPU too, so the
    result never aliases the host array), as `dtype` when given.  A tensor
    moves as ``Tensor.to`` moves it."""
    with _STAGING:
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=dtype)
        np_dtype = _NP_DTYPES.get(dtype)
        arr = np.asarray(a, dtype=np_dtype)
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
        if np_dtype is not None:
            dtype = None  # converted on the host: no device cast, no wide copy
        return torch.from_numpy(arr).to(device=device, dtype=dtype, copy=True)


class fetch_point:
    """A declared device -> host read: the syncs inside the block are
    deliberate, and `why` names them.  An armed guard counts the block
    under `why`."""

    __slots__ = ("why",)

    def __init__(self, why: str) -> None:
        self.why = why

    def __enter__(self) -> None:
        _TLS.fetching.append(self.why)
        g = _TLS.guard
        if g is not None:
            g.fetches[self.why] += 1

    def __exit__(self, *exc) -> None:
        _TLS.fetching.pop()


def fetch(t: torch.Tensor, why: str) -> np.ndarray:
    """A host copy of `t` that never aliases it, read at a declared fetch
    point named `why`."""
    with fetch_point(why):
        return t.to("cpu", copy=True).numpy()


def _tensors(args, kwargs) -> Iterator[torch.Tensor]:
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor):
                    yield b
    if kwargs:
        for a in kwargs.values():
            if isinstance(a, torch.Tensor):
                yield a


class _GuardMode(TorchDispatchMode):
    """The transfer guard's dispatch mode: counts aten ops and records the
    first violation (module doc)."""

    def __init__(self, device: torch.device) -> None:
        super().__init__()
        self.on_card = device.type == "cuda"
        self.ops = 0
        self.fetches: Counter = Counter()
        self.violation: Optional[SanitizerViolation] = None

    def _fail(self, msg: str) -> None:
        v = SanitizerViolation(msg)
        if self.violation is None:
            self.violation = v
        raise v

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        tls = _TLS
        staging = tls.staging > 0
        fetching = bool(tls.fetching)
        if func in _SYNC_OPS and not fetching:
            self._fail(
                f"implicit device->host sync ({func}) outside a declared "
                "fetch point: read the value through sanitizer.fetch / "
                "fetch_point (and name why), or keep it on the device"
            )
        ins = list(_tensors(args, kwargs))
        if not staging:
            on_card = self.on_card and any(t.is_cuda for t in ins)
            for t in ins:
                if getattr(t, _HOST_TAG, False) and (on_card or not self.on_card):
                    self._fail(
                        f"implicit host->device transfer: host data reached "
                        f"{func} without the engine's explicit staging "
                        "(sanitizer.stage / the engine's _put)"
                    )
        out = func(*args, **(kwargs or {}))
        if func in _LIFT_OPS:
            # a 0-dim tensor of a Python scalar (`t[i] = 0`) is an
            # argument of the op, not host data
            if not staging and isinstance(out, torch.Tensor) and out.dim() > 0:
                if out.is_cuda:
                    self._fail(
                        "implicit host->device transfer: host data was made "
                        "a tensor directly on the card outside the engine's "
                        "explicit staging"
                    )
                setattr(out, _HOST_TAG, True)
        elif self.on_card and func in _COPY_OPS and ins and isinstance(out, torch.Tensor):
            src = ins[-1] if func is not _aten._to_copy.default else ins[0]
            if out.is_cuda and not src.is_cuda and src.dim() > 0 and not staging:
                self._fail(
                    "implicit host->device transfer: a CPU tensor was "
                    f"copied to the card by {func} outside the engine's "
                    "explicit staging"
                )
            if not out.is_cuda and src.is_cuda and not fetching:
                self._fail(
                    f"implicit device->host sync: {func} copied a device "
                    "tensor to the host outside a declared fetch point"
                )
        return out


class EngineSanitizer:
    """Wraps a :class:`DeviceResidencyEngine`'s dispatches in runtime
    contract checks.  Stateless between blocks apart from the record of
    the last guarded block (`last`); cheap to construct."""

    def __init__(self, engine) -> None:
        self.engine = engine
        # the last guarded block: aten ops seen and fetch points passed
        self.last: dict = {"ops": 0, "fetches": {}}

    @contextmanager
    def transfer_guard(self) -> Iterator[None]:
        """Fail the block on an implicit host->device transfer or an
        undeclared device->host sync (module doc)."""
        mode = _GuardMode(torch.device(self.engine.device))
        prev = _TLS.guard
        _TLS.guard = mode
        try:
            with mode:
                yield
        except SanitizerViolation:
            raise
        except Exception as e:
            if mode.violation is not None:
                raise mode.violation from e
            raise
        finally:
            _TLS.guard = prev
            self.last = {"ops": mode.ops, "fetches": dict(mode.fetches)}
        if mode.violation is not None:
            raise mode.violation

    @contextmanager
    def compile_budget(self, allowed: int = 0) -> Iterator[None]:
        """Fail the block if the engine runs more than ``allowed`` ladder
        keys it had not run before (default: none — steady state lands on
        keys already run)."""
        before = set(self.engine.cached_program_keys())
        yield
        new = [k for k in self.engine.cached_program_keys() if k not in before]
        if len(new) > allowed:
            raise SanitizerViolation(
                f"engine ran {len(new)} new ladder key(s) inside a "
                f"compile_budget({allowed}) block ({new[:3]}); a "
                "steady-state query must land on a key already run — check "
                "that the key doesn't include per-query state"
            )

    @contextmanager
    def sanitized(self, allowed_compiles: int = 0) -> Iterator[None]:
        """Both checks at once: the steady-state dispatch contract."""
        with self.transfer_guard():
            with self.compile_budget(allowed_compiles):
                yield
