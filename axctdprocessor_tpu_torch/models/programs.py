"""Cached decode programs: one per static shape, captured once as a CUDA
graph on the card and replayed on every warm decode (the counterpart of the
JAX package's compiled programs: ``models/tpu_engine._fused`` with its host
tables cached by ``_engine_tables_cached``, ``parallel/batch._batched_fused``
under ``lru_cache(maxsize=8)``, and ``models/segmented._resident_program``).

The JAX package compiles a decode once per static shape (``jax.jit`` with
static ``dims`` / ``fs`` / ``decimate2``) and then runs it as one dispatch.
Here a :class:`Program` holds the decode's module with its tables already on
the device (uploaded once) and static input buffers; on a GPU its forward is
captured once as a ``torch.cuda.CUDAGraph``, and one graph launch then queues
the ~1,200 kernels that the eager forward queues one Python op at a time.

* **A call** copies its inputs into the static buffers on the current stream
  (:meth:`Program.load`), runs the forward and returns a clone of the static
  output, made on the same stream (:meth:`Program.run`): a later call never
  overwrites a tensor a caller holds (the batch path's fetch of batch k-1 on
  a side stream may still be reading it while batch k replays).
* **When a shape is captured.** The first call of a program runs the forward
  eagerly over the static buffers: the warm-up a capture needs (cuFFT plans,
  the kernel launchers' one-time ``cudaFuncSetAttribute`` /
  ``cudaDeviceGetAttribute``), and a one-shot decode captures nothing, as
  jit compiles on the first call.  The second call captures and replays;
  later calls replay.  PyTorch's advice to warm up on a side stream does not
  matter here: it protects state that training binds to the stream that
  warms up (autograd's accumulation streams, DDP's hooks, cuBLAS
  workspaces), and these forwards run in inference mode, take no gradient
  and call no cuBLAS; cuFFT plans are cached by shape, not by stream.  The
  warm-up runs on the current stream, the capture on ``torch.cuda.graph``'s
  own side stream.  Entering ``torch.cuda.graph`` synchronizes the device
  and empties PyTorch's cache: a capture costs more than a warm decode.
* **On the CPU** every call runs the forward eagerly over the static
  buffers, copies its result into the static output and returns a clone:
  the data flow of a replay without a graph, so that a stale static input
  or a static output overwritten before it is read shows on the CPU too.
* **No fallback.** A capture that fails raises; the program stays uncaptured
  and its next call captures again (and raises again).  Nothing decodes
  eagerly in its place.  The eager module stays reachable as its own
  ``forward`` (``FusedDecoder.forward``, ``SegmentedDecoder.forward``).
* **Constants frozen at capture.** Every Python scalar the forward reads and
  every table it holds becomes a constant of the graph, so each belongs to
  the key (``engine.fused_program``: the kind, ``EngineDims``, ``fs``,
  ``decimate2``, the plain tone version, the input's dtype and shape, which
  carry the wire, the device, ``bitrate``, ``bit_inset``, ``edge_pad`` and
  the bytes of the tables) or to the program's owner (a prestaged drop's
  segment count and valid length: its program is the drop's own).  No
  forward copies a host array or fills a tensor with a value that changes
  from decode to decode: ``n_valid`` is a static input.
* **Kernel counters.** The wrappers count their launches in Python when they
  are called (``launches``, ``streamed_launches``); a replay calls no
  wrapper.  A capture records each count's change and the launchers' own
  records (``tone_last_launch()``, ``probe_last_launch()``) as the program's
  ``deltas`` and ``records``; every replay adds the deltas again, so a count
  reads one launch per kernel per decode, replayed or not.
* **The cache** (:func:`cached`) holds at most ``MAX_PROGRAMS`` programs,
  the least recently used evicted first; evicting one releases its graph and
  its private memory pool.  The graphs hold the cuFFT plans their warm-up
  made: PyTorch's plan cache (4,096 plans a device by default) must keep
  them, two or four plans a program.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..ops import chain, goertzel, tonepower

MAX_PROGRAMS = 8  # the JAX package's lru_cache(maxsize=8) over batch programs

# the wrappers that count their kernel launches, by module and name (looked
# up when read, so that a stand-in for a wrapper counts as the wrapper does)
COUNTED = ((tonepower, "tone_ratios"), (tonepower, "tone_powers"), (goertzel, "probe_at"),
           (chain, "chain_enumerate_strided"), (chain, "chain_enumerate_frames"),
           (chain, "chain_walk"))
COUNTS = ("launches", "streamed_launches")


def _read_counts() -> dict:
    out = {}
    for mod, name in COUNTED:
        fn = getattr(mod, name)
        for count in COUNTS:
            if hasattr(fn, count):
                out[(mod.__name__, name, count)] = getattr(fn, count)
    return out


def _add_counts(deltas: dict) -> None:
    for mod, name in COUNTED:
        fn = getattr(mod, name)
        for count in COUNTS:
            d = deltas.get((mod.__name__, name, count))
            if d:
                setattr(fn, count, getattr(fn, count) + d)


def _launch_records(deltas: dict) -> dict:
    """The launchers' records of the last tone and probe launch a capture
    made (None for a kernel it did not launch)."""
    from ..ops.kernels import extension

    def ran(*names):
        return any(d for (_, name, count), d in deltas.items()
                   if name in names and count == "launches")

    ext = extension()
    return {"tone": tuple(ext.tone_last_launch()) if ran("tone_ratios", "tone_powers") else None,
            "probe": tuple(ext.probe_last_launch()) if ran("probe_at") else None}


def _load(buf: torch.Tensor, value) -> None:
    """One input into its static buffer on the current stream: a Python
    number as a fill, an array or tensor as a copy (host arrays through
    pinned memory, without a host sync)."""
    if isinstance(value, (int, float)):
        buf.fill_(value)
        return
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(value))
    if t.shape != buf.shape or t.dtype != buf.dtype:
        raise ValueError(f"input {t.dtype} {tuple(t.shape)} for a static buffer "
                         f"{buf.dtype} {tuple(buf.shape)}")
    if buf.is_cuda and t.device.type == "cpu":
        t = t.pin_memory()
    buf.copy_(t, non_blocking=True)


class Program:
    """`forward` over static input buffers `inputs` on `device`: eager on its
    first call and on the CPU, captured as a CUDA graph at its second call on
    a GPU and replayed after that (see the module's docstring).  `module` is
    the decoder it runs, if any; ``fetch_stream`` is a stream of its own on a
    GPU for copying its outputs out behind it (the batch path's fetch)."""

    def __init__(self, forward, inputs: tuple, device, module=None):
        self.forward, self.inputs, self.module = forward, tuple(inputs), module
        self.device = torch.device(device)
        self.fetch_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.calls = 0
        self.graph = self.output = None
        self.deltas, self.records = {}, {}

    def __call__(self, *values) -> torch.Tensor:
        self.load(*values)
        return self.run()

    def load(self, *values) -> None:
        """The inputs into the static buffers, in order."""
        if len(values) != len(self.inputs):
            raise ValueError(f"{len(values)} inputs for {len(self.inputs)} static buffers")
        with torch.inference_mode():
            for buf, value in zip(self.inputs, values):
                _load(buf, value)

    def run(self) -> torch.Tensor:
        """One decode over the static buffers; a clone of the static output."""
        with torch.inference_mode():
            if self.device.type != "cuda" or self.calls == 0:
                self.run_eager()
            elif self.graph is None:
                self.capture()
            else:
                self.replay()
            self.calls += 1
            return self.output.clone()

    def run_eager(self) -> None:
        """The forward, run eagerly, into the static output."""
        out = self.forward(*self.inputs)
        if self.output is None:
            self.output = out
        else:
            self.output.copy_(out)

    def capture(self) -> None:
        """Capture the forward as a CUDA graph (its kernels' counts and
        launch records with it), then replay it once.  Raises if the capture
        fails, with the counts as they were."""
        before = _read_counts()
        stream = torch.cuda.current_stream(self.device)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = self.forward(*self.inputs)
        except BaseException:
            torch.cuda.set_stream(stream)  # a failed capture leaves its own stream current
            now = _read_counts()
            _add_counts({k: before[k] - now[k] for k in before})
            raise
        after = _read_counts()
        self.deltas = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self.records = _launch_records(self.deltas)
        self.graph, self.output = graph, out
        graph.replay()

    def replay(self) -> None:
        """The captured graph once, its kernels' counts added."""
        _add_counts(self.deltas)
        self.graph.replay()

    def release(self) -> None:
        """Drop the graph, its private memory pool and the buffers."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.output = self.module = self.forward = None
        self.inputs = ()


_cache: collections.OrderedDict = collections.OrderedDict()


def cached(key, build) -> Program:
    """The program of `key`, made by ``build()`` on a miss; the least
    recently used program beyond ``MAX_PROGRAMS`` is evicted and released."""
    program = _cache.get(key)
    if program is not None:
        _cache.move_to_end(key)
        return program
    program = _cache[key] = build()
    while len(_cache) > MAX_PROGRAMS:
        _cache.popitem(last=False)[1].release()
    return program


def programs() -> list:
    """The cached programs, least recently used first."""
    return list(_cache.values())


def clear() -> None:
    """Evict and release every cached program."""
    while _cache:
        _cache.popitem(last=False)[1].release()


def table_key(tables: dict) -> tuple:
    """The numpy tables as a key: name, dtype, shape and bytes of each."""
    return tuple((name, a.dtype.str, a.shape, a.tobytes())
                 for name, a in sorted(tables.items()))
