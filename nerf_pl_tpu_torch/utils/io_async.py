"""Background IO for the training loop (``nerf_pl_tpu/utils/io_async.py``).

``AsyncWriter`` is a single ordered worker thread: the trainers hand it
their checkpoint writes, validation PNG dumps and TensorBoard images, so the
host's serialisation overlaps the next steps on the card instead of running
between them.

One thread, FIFO: checkpoint top-k bookkeeping and log files see writes in
submission order, exactly as a synchronous loop would.  Errors in the
worker re-raise on the next ``submit``/``drain``, so a failed write cannot
silently drop checkpoints.

PyTorch's optimisers update the parameters in place, so a write must not
read the live tensors: ``snapshot`` clones a tree's tensors on their device
on the calling thread and records a CUDA event after the clones;
``Snapshot.fetch``, called in the worker, waits for that event and copies
the clones to the host on a stream of its own, so the copy waits for the
clones and for nothing queued after them.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Optional

import torch


class AsyncWriter:
    """Single ordered background thread for checkpoint/image/log writes."""

    def __init__(self, name: str = "io-writer"):
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        self._exc: Optional[BaseException] = None
        # own pending counter + condition instead of Queue.join(): a timed
        # drain waits with a deadline directly, without a waiter thread that
        # would stay blocked whenever the timeout fires first
        self._pending = 0
        self._cond = threading.Condition()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=name
        )
        self._thread.start()

    def _loop(self):
        while True:
            fn = self._q.get()
            try:
                if fn is not None and self._exc is None:
                    fn()
            except BaseException as e:  # noqa: BLE001 — surfaced on submit
                self._exc = e
            finally:
                with self._cond:
                    self._pending -= 1
                    self._cond.notify_all()

    def _check(self):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError("background write failed") from exc

    def submit(self, fn: Callable[[], None]) -> None:
        """Enqueue a write; raises if a PREVIOUS write failed."""
        self._check()
        with self._cond:
            self._pending += 1
        self._q.put(fn)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted write has finished; re-raise any
        failure.  Call before reading checkpoints back, at ``fit`` exit, and
        on preemption.

        ``timeout`` (seconds) bounds the wait, for the preemption save:
        better to save a resumable state with a write still pending than to
        wait on a write that cannot finish.  A timed-out drain still
        re-raises any failure from writes that did complete before
        returning, so an earlier background error cannot be swallowed."""
        with self._cond:
            self._cond.wait_for(lambda: self._pending == 0, timeout=timeout)
        self._check()


def _map(tree: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


class Snapshot:
    """A tree whose tensors were cloned on their device (see ``snapshot``);
    ``fetch`` gives it with every tensor on the host."""

    def __init__(self, tree: Any, event: Optional[torch.cuda.Event],
                 device: Optional[torch.device]):
        self._tree, self._event, self._device = tree, event, device

    def fetch(self) -> Any:
        """The tree on the host.  Safe on any thread: on the card the copy
        runs on a stream of its own once the clones are done."""
        if self._event is None:
            return self._tree
        self._event.synchronize()
        with torch.cuda.device(self._device):
            stream = torch.cuda.Stream()
            stream.wait_event(self._event)
            with torch.cuda.stream(stream):
                host = _map(self._tree, lambda t: t.to("cpu"))
            stream.synchronize()
        return host


def snapshot(tree: Any) -> Snapshot:
    """Clone every tensor of ``tree`` (nested dicts, lists, tuples) on its
    device, on the calling thread's current stream, and record an event
    after the clones when any lies on a card."""
    devices = []

    def clone(t: torch.Tensor) -> torch.Tensor:
        if t.device.type == "cuda":
            devices.append(t.device)
        return t.detach().clone()

    tree = _map(tree, clone)
    if not devices:
        return Snapshot(tree, None, None)
    if len(set(devices)) > 1:
        raise ValueError(f"snapshot of tensors on several cards: "
                         f"{sorted(set(map(str, devices)))}")
    with torch.cuda.device(devices[0]):
        event = torch.cuda.Event()
        event.record()
    return Snapshot(tree, event, devices[0])
