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
  warm-up runs on the current stream, the capture on a side stream of the
  program's own on its device (``capture_stream``), in the thread-local
  capture mode: the pipeline's stager thread uploads the next batch on a
  stream of its own while the main thread captures, and in the global mode
  its calls invalidate the capture.  ``torch.cuda.graph``'s default capture
  stream is one stream, made on whichever device was current at the first
  capture of the process; a program on another GPU (the pipeline's back
  half on a second card) would capture its kernels' device's current
  stream, not the capture stream.  So every call runs with the program's
  device current, and each program captures on a stream of that device.
  Entering ``torch.cuda.graph`` synchronizes the device and empties
  PyTorch's cache: a capture costs more than a warm decode.
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
* **Several inputs and outputs.** A forward may return one tensor, a tuple
  or a dict of tensors (the segment program's five outputs, the pipeline's
  stage 1); each is cloned on the current stream.  ``run(clone=False)``
  hands back the static outputs themselves, for a caller that copies them
  on the same stream before the program's next call (the segment programs'
  outputs into the assemble program's static inputs).  :meth:`Program.load_at`
  writes one input: the assemble's are filled from several segment calls.
* **Spans** (``utils.profiling.span``, on the timer of the decode's entry
  point): ``program.build`` (a miss's build), ``program.eager`` (a
  program's first call), ``program.capture``, ``program.evict`` (each
  release by the cache) and ``pin_upload`` (a host array into a static
  input); a warm call's replay opens none.
* **The cache** (:func:`cached`) holds at most ``MAX_PROGRAMS`` programs of
  one kind on each device (the first item of a key: the JAX package keeps an
  ``lru_cache(maxsize=8)`` for each of its program kinds; one count over
  all kinds would thrash a process that serves the monolithic, batch,
  segmented, stream and pipeline paths, whose warm shapes number 11 in
  ``chip_smoke.py``'s phase 9h; one count over all devices would thrash a
  ``dp`` mesh, whose batches make a program on every card), and what their
  graphs hold on a card at most ``1 / POOL_SHARE`` (a third) of its memory
  (:attr:`Program.bytes`: the private pool, ``pool_bytes``, read once after
  the capture from ``torch.cuda.memory_snapshot()``, and the static inputs).
  A cached XLA
  executable holds no activations, but a captured graph keeps its whole
  pool (12.1 GiB for 64 rows of 120 s), so the JAX package's count alone
  does not bound the card's memory.  The least recently used programs are
  evicted first, never the one just used nor a pinned one (:func:`pin`:
  the programs of a running decode, :func:`pinned`, and those a live
  stream holds from its constructor to its ``finalize()``); a pinned
  program's bytes count against the budget all the same, so while pinned
  programs alone exceed it the cache holds more.  The bound is enforced at
  each lookup and again after each capture, since a capture is what makes
  the bytes.  Evicting one releases its graph and its pool; its next call
  builds it again (no eager decode in its place).  The graphs hold the
  cuFFT plans their warm-up made: PyTorch's plan cache (4,096 plans a
  device by default) must keep them, two or four plans a program.
* **Counters** (:func:`cache_stats`, per device, since the process
  started): the builds (misses), the captures, the evictions (the bounds'
  releases; :func:`clear` counts none), the bytes held and the most held,
  read after each build and after each capture, before its evictions.
"""

from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch

from ..ops import chain, goertzel, tonepower
from ..utils import profiling

# Of one kind on each device: the JAX package's lru_cache(maxsize=8) over each program kind.
# Its entries are executables, and an executable spans the mesh: a batch over a dp mesh of four
# is one entry there and a program on each of four cards here.  Counted over every card, a pass
# of the archive at batch_size=32 over dp=4 (3-4 shapes a card, 12-16 programs) built, ran eagerly
# and evicted 12 of them again: 186 ms a batch on four H100s (PERF.md, the archive.dp4 cell).
MAX_PROGRAMS = 8
# The cached graphs' pools and static inputs hold at most a third of the card's memory
# (26.39 GiB of an H100 80GB).  The archive at the JAX package's 64-drop batch unit keeps
# three batch programs a pass, measured at 12.75 GiB (64 rows of 120 s), 11.37 GiB (57 rows
# of 120 s) and 0.79 GiB (7 float rows of 60 s): 24.91 GiB, over a quarter (19.79 GiB), so
# at a quarter every warm pass built, captured and evicted one of them again.  The eager
# first call of a 64 x 120 s program takes 10.1 GiB more beside them (PERF.md, PR 20).
POOL_SHARE = 3

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
    pinned memory, without a host sync: the span ``pin_upload``)."""
    if isinstance(value, (int, float)):
        buf.fill_(value)
        return
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(value))
    if t.shape != buf.shape or t.dtype != buf.dtype:
        raise ValueError(f"input {t.dtype} {tuple(t.shape)} for a static buffer "
                         f"{buf.dtype} {tuple(buf.shape)}")
    if t.device.type == "cpu" and (buf.is_cuda or t is not value):  # a host array
        with profiling.span("pin_upload"):
            buf.copy_(t.pin_memory() if buf.is_cuda else t, non_blocking=True)
        return
    buf.copy_(t, non_blocking=True)


def _each(fn, out):
    """`fn` over one output tensor, or over each of a tuple or dict of them."""
    if isinstance(out, dict):
        return {k: fn(v) for k, v in out.items()}
    if isinstance(out, tuple):
        return tuple(fn(v) for v in out)
    return fn(out)


def _leaves(out) -> tuple:
    """The output tensors: one, or each of a tuple or dict."""
    if isinstance(out, dict):
        return tuple(out.values())
    return out if isinstance(out, tuple) else (out,)


def _current(device: torch.device):
    """`device` current while the block runs (a GPU), else nothing."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _pool_bytes(graph) -> int:
    """The bytes of a captured graph's private memory pool: the segments of
    ``torch.cuda.memory_snapshot()`` under its id."""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


class Program:
    """`forward` over static input buffers `inputs` on `device`: eager on its
    first call and on the CPU, captured as a CUDA graph at its second call on
    a GPU and replayed after that (see the module's docstring).  `module` is
    the decoder it runs, if any; ``fetch_stream`` is a stream of its own on a
    GPU for copying its outputs out behind it (the batch path's fetch);
    ``capture_stream`` the stream of its device that its capture runs on;
    ``pool_bytes`` the bytes its graph's private pool holds (0 until a
    capture, and on the CPU); ``key`` its key in the cache, if cached."""

    def __init__(self, forward, inputs: tuple, device, module=None):
        self.forward, self.inputs, self.module = forward, tuple(inputs), module
        self.device = torch.device(device)
        on_card = self.device.type == "cuda"
        self.fetch_stream = torch.cuda.Stream(self.device) if on_card else None
        self.capture_stream = torch.cuda.Stream(self.device) if on_card else None
        self.input_bytes = sum(t.numel() * t.element_size() for t in self.inputs) if on_card else 0
        self.calls = self.pins = self.pool_bytes = 0
        self.graph = self.output = self.key = None
        self.deltas, self.records = {}, {}

    @property
    def bytes(self) -> int:
        """What the cache's budget counts for it: its graph's pool and its
        static inputs, on a card."""
        return self.pool_bytes + self.input_bytes

    def __call__(self, *values):
        self.load(*values)
        return self.run()

    def load(self, *values) -> None:
        """The inputs into the static buffers, in order."""
        if len(values) != len(self.inputs):
            raise ValueError(f"{len(values)} inputs for {len(self.inputs)} static buffers")
        for i, value in enumerate(values):
            self.load_at(i, value)

    def load_at(self, index: int, value) -> None:
        """One input into its static buffer."""
        with torch.inference_mode():
            _load(self.inputs[index], value)

    def run(self, clone: bool = True):
        """One decode over the static buffers: a clone of the static output
        (each of a tuple or dict), or with ``clone=False`` the static output
        itself, which the program's next call overwrites."""
        if self.forward is None:
            raise RuntimeError("the program was released (evicted or cleared)")
        with torch.inference_mode(), _current(self.device):
            if self.calls == 0:
                with profiling.span("program.eager"):
                    self.run_eager()
            elif self.device.type != "cuda":
                self.run_eager()
            elif self.graph is None:
                self.capture()
            else:
                self.replay()
            self.calls += 1
            return _each(torch.clone, self.output) if clone else self.output

    def run_eager(self) -> None:
        """The forward, run eagerly, into the static output."""
        out = self.forward(*self.inputs)
        if self.output is None:
            self.output = out
        else:
            for dst, src in zip(_leaves(self.output), _leaves(out)):
                dst.copy_(src)

    def capture(self) -> None:
        """Capture the forward as a CUDA graph (its kernels' counts and
        launch records with it), then replay it once; its pool's bytes are
        read and the cache's bound enforced.  Raises if the capture fails,
        with the counts as they were.  The span ``program.capture`` holds
        all but the eviction (``program.evict``)."""
        with profiling.span("program.capture"):
            before = _read_counts()
            stream = torch.cuda.current_stream(self.device)
            graph = torch.cuda.CUDAGraph()
            try:
                # thread-local: another thread's CUDA calls (the pipeline's stager
                # pinning and uploading the next batch on its own stream) neither
                # join nor invalidate this capture
                with torch.cuda.graph(graph, stream=self.capture_stream,
                                      capture_error_mode="thread_local"):
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
            self.pool_bytes = _pool_bytes(graph)
            graph.replay()
            _note(self.device, "captures")
        _evict(keep=self)

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
        self.pool_bytes = self.input_bytes = 0


_cache: collections.OrderedDict = collections.OrderedDict()
# by device (``device_key``): builds, captures, evictions, peak_held_bytes
_stats: collections.defaultdict = collections.defaultdict(collections.Counter)


def _note(device, count: str) -> None:
    """One more of `count` on `device`, and the bytes held there now
    against the most held."""
    st = _stats[device_key(device)]
    st[count] += 1
    st["peak_held_bytes"] = max(st["peak_held_bytes"], held_bytes(device))


def cache_stats(device) -> dict:
    """What the cache did on `device` since the process started: its
    ``builds``, ``captures`` and ``evictions``; the bytes its programs hold
    now (``held_bytes``) and the most they held (``peak_held_bytes``)."""
    st = _stats[device_key(device)]
    held = held_bytes(device)
    return {"builds": st["builds"], "captures": st["captures"], "evictions": st["evictions"],
            "held_bytes": held, "peak_held_bytes": max(st["peak_held_bytes"], held)}


def pool_budget(device: torch.device) -> int | None:
    """The bytes the cached programs on `device` may hold (their graphs'
    pools and static inputs): a ``POOL_SHARE``-th of a card's memory; no
    bound on the CPU (no pools)."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory // POOL_SHARE


def _kind(key):
    """A key's kind, its first item (``"fused"``, ``"segment"``, ...)."""
    return key[0] if isinstance(key, tuple) else key


def _evict(keep: Program | None = None) -> None:
    """Evict and release the least recently used programs until the cache
    holds at most ``MAX_PROGRAMS`` of each kind on each device and each
    device's programs at most its ``pool_budget``; never `keep` nor a pinned
    program."""
    def drop(which) -> bool:
        key = next((k for k, p in _cache.items()
                    if p is not keep and not p.pins and which(k, p)), None)
        if key is not None:
            with profiling.span("program.evict"):
                evicted = _cache.pop(key)
                evicted.release()
                _note(evicted.device, "evictions")
        return key is not None

    for kind, device in {(_kind(k), p.device) for k, p in _cache.items()}:
        def mate(k, p, kind=kind, device=device):
            return _kind(k) == kind and p.device == device

        while (sum(mate(k, p) for k, p in _cache.items()) > MAX_PROGRAMS
               and drop(mate)):
            pass
    for device in {p.device for p in _cache.values()}:
        budget = pool_budget(device)
        while (budget is not None and held_bytes(device) > budget
               and drop(lambda k, p: p.device == device and p.bytes)):
            pass


def cached(key, build) -> Program:
    """The program of `key`, made by ``build()`` on a miss (the span
    ``program.build``); the least recently used programs beyond the cache's
    bounds are evicted and released (``program.evict``, each)."""
    program = _cache.get(key)
    if program is None:
        with profiling.span("program.build"):
            program = _cache[key] = build()
        program.key = key
        _note(program.device, "builds")
    _cache.move_to_end(key)
    _evict(keep=program)
    return program


def pin(*held: Program) -> None:
    """`held` are not evicted until :func:`unpin` (pins count)."""
    for p in held:
        p.pins += 1


def unpin(*held: Program) -> None:
    for p in held:
        p.pins -= 1


@contextlib.contextmanager
def pinned(*held: Program):
    """While the block runs, `held` (the programs of one decode) are not
    evicted, whatever another's capture adds to the cache."""
    pin(*held)
    try:
        yield
    finally:
        unpin(*held)


def programs() -> list:
    """The cached programs, least recently used first."""
    return list(_cache.values())


def held_bytes(device=None) -> int:
    """The bytes the cached programs hold, graph pools and static inputs
    (on `device`)."""
    dev = None if device is None else device_key(device)
    return sum(p.bytes for p in _cache.values() if dev is None or device_key(p.device) == dev)


def clear() -> None:
    """Evict and release every cached program, pinned ones too (no
    eviction in :func:`cache_stats`)."""
    while _cache:
        _cache.popitem(last=False)[1].release()


def device_key(device) -> torch.device:
    """`device` as a key holds it: a GPU with its index (the current one
    where none is given)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def table_key(tables: dict) -> tuple:
    """The numpy tables as a key: name, dtype, shape and bytes of each."""
    return tuple((name, a.dtype.str, a.shape, a.tobytes())
                 for name, a in sorted(tables.items()))
