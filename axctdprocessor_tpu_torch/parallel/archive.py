"""Archive reprocessing: decode a corpus of WAV drops in batches, on one device
or with every batch data-parallel over a mesh (port of
axctdprocessor_tpu.parallel.archive).

Design:

* **length bucketing** — drops are grouped by sample rate and padded length
  (rounded up to a bucket granularity) so each bucket has one shape and pads
  little;
* **host/device pipelining** — while the device decodes batch k, a
  background thread loads batch k+1, and batch k-1 is fetched and its
  reports written (``batch.dispatch_batch`` queues a batch and the copy of
  its result without waiting for the device; the copy runs on a side stream
  behind its own batch only, so ``finish_dispatched`` of batch k-1 does not
  wait for batch k);
* **reader pool** — a batch's files are read at once, one a task on a pool
  of up to ``READERS`` threads (no more than the batch has files or the
  host has cores): the decimation of files above 50 kHz and numpy's float
  passes release the GIL;
* **checkpoint/resume** — a JSON manifest in the output directory records
  per-file status, so a preempted job re-run with ``resume=True`` skips
  completed drops;
* **failure isolation** — an unreadable file is recorded as ``failed`` in
  the manifest and the rest of its batch decodes;
* per-drop ``output.txt`` reports with the exact writer contract.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..models import programs
from ..models.engine import resolve_device
from ..utils import profiling
from ..utils.config import resolve_settings
from ..utils.profiling import StageTimer
from ..utils.report import write_report
from ..utils.wavio import read_wav, read_wav_raw16
from .batch import dispatch_batch, finish_dispatched, retry_lossy_rows

BUCKET_SECONDS = 60  # pad each drop up to a whole minute bucket
# the stages the manifest's stage_times keeps (the JAX package's); the timer
# holds the finer spans too
MANIFEST_STAGES = ("io.read_wavs", "io.write_reports", "device.dispatch_batch",
                   "device.fetch_batch")
CACHE_COUNTS = ("builds", "captures", "evictions")  # the manifest's program_cache
READERS = 8  # the most reader threads a batch's files are read on at once


def _cache_counts(devices) -> dict:
    """The program cache's counts (``programs.cache_stats``) and the bytes it
    holds, summed over `devices`."""
    stats = [programs.cache_stats(d) for d in devices]
    return {k: sum(st[k] for st in stats) for k in CACHE_COUNTS + ("held_bytes",)}


def _manifest_path(out_dir: str) -> str:
    return os.path.join(out_dir, "manifest.json")


def _load_manifest(out_dir: str) -> dict:
    path = _manifest_path(out_dir)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"files": {}}


def _save_manifest(out_dir: str, manifest: dict) -> None:
    with profiling.span("io.save_manifest"):
        tmp = _manifest_path(out_dir) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, _manifest_path(out_dir))


def _read_and_condition(path: str):
    from ..utils.native import read_wav_conditioned_f32

    fast = read_wav_conditioned_f32(path)  # C++ reader; releases the GIL
    if fast is not None:
        return fast
    pcm, fs = read_wav(path)
    return np.asarray(pcm, dtype=np.float32), fs


@profiling.entry_point(default=StageTimer)
def reprocess_corpus(wav_paths: list[str], out_dir: str,
                     settings: dict | None = None, compat: str = "strict",
                     *, device="cuda", mesh=None, batch_size: int = 8,
                     resume: bool = True, timer: StageTimer | None = None,
                     wire: str = "auto", diagnostics: bool = False) -> dict:
    """Decode every WAV on `device` into `out_dir`/<name>.txt; returns the
    manifest.  Asking for a GPU that is not there raises before any work.
    With a `mesh` (``parallel.mesh.make_mesh``) each batch runs data-parallel
    over its ``dp`` axis (``batch.dispatch_batch``) and `device` is not read.
    ``timer`` (a ``StageTimer`` by default; ``utils.profiling.entry_point``)
    takes the runner's stages, the spans below them and, on the main thread,
    the wait for the readers (``io.wait_reader``), the batch array
    (``pad_batch``), the plan (``plan_batches``) and each manifest write
    (``io.save_manifest``), and on the reader threads each file's read
    (``io.read_file``, inside its batch's ``io.read_wavs``); the manifest's ``stage_times`` keeps
    ``MANIFEST_STAGES``, and its ``program_cache`` the program cache's
    builds, captures and evictions that this call made on its devices, and
    the bytes the cache holds there at its end."""
    if mesh is None:
        device = resolve_device(device)
    devices = {programs.device_key(d)
               for d in (mesh.devices_along("dp") if mesh is not None else [device])}
    cache_before = _cache_counts(devices)
    os.makedirs(out_dir, exist_ok=True)
    cfg = resolve_settings(settings, compat=compat)
    manifest = _load_manifest(out_dir) if resume else {"files": {}}

    todo = [p for p in wav_paths
            if manifest["files"].get(os.path.basename(p), {}).get("status")
            != "done"]

    # group by sample rate (a batch must decode at one fs), then bucket by
    # padded duration so compilations are shared
    _fs_cache: dict[str, int] = {}

    def fs_of(path):
        if path in _fs_cache:
            return _fs_cache[path]
        from ..utils.native import wav_info

        info = wav_info(path)
        if info is not None:
            fs = info[0]
        else:
            try:
                from scipy.io import wavfile

                fs = int(wavfile.read(path, mmap=True)[0])
            except Exception:
                fs = -1  # unreadable; quarantined at load time
        _fs_cache[path] = fs
        return fs

    def bucket_of(path):
        nbytes = os.path.getsize(path)
        fs = fs_of(path)
        # duration estimate from the real sample rate (16-bit mono bytes);
        # a fixed 44.1 kHz guess bucketed 22.05 kHz corpora 2x off,
        # splitting batches that could share a compilation.  Hint-only.
        seconds = nbytes / (2 * (fs if fs > 0 else 44100))
        return int(np.ceil(max(seconds, 1) / BUCKET_SECONDS))

    with timer.stage("plan_batches"):
        todo.sort(key=lambda p: (fs_of(p), bucket_of(p)))
        batches = []
        current: list[str] = []
        current_fs = None
        for p in todo:
            f = fs_of(p)
            if current and (f != current_fs or len(current) >= batch_size):
                batches.append(current)
                current = []
            current_fs = f
            current.append(p)
        if current:
            batches.append(current)

    def read_file(path):
        # one file of a batch, on a reader thread: (its samples, fs) and
        # whether it took the float path, or the exception it raised
        with timer.stage("io.read_file"):
            try:
                r = read_wav_raw16(path)
                if r is None:
                    return _read_and_condition(path), True
                return r, False
            except Exception as e:
                return e, False

    def load_batch(paths):
        # Per-file loading: one unreadable or odd-format file is isolated
        # (recorded in the manifest), never demotes or aborts the batch.
        # Raw int16 ships at half the bytes and conditions on device, but
        # a batch must be dtype-uniform — if any file needs the float
        # path, the raw rows are host-conditioned to match (same raw-int
        # DC/peak statistics as utils.wavio.read_wav).
        with timer.stage("io.read_wavs"):
            read = list(readers.map(read_file, paths))  # in the batch's order
            items = [(r, p) for (r, _), p in zip(read, paths)]
            if any(is_float for _, is_float in read):
                for k, (r, p) in enumerate(items):
                    if isinstance(r, Exception):
                        continue
                    pcm, wav_fs = r
                    if np.issubdtype(np.asarray(pcm).dtype, np.integer):
                        dc = np.mean(pcm)
                        peak = np.max(np.abs(pcm))
                        pcm = ((pcm.astype(np.float64) - dc)
                               / max(peak, 1)).astype(np.float32)
                        items[k] = ((pcm, wav_fs), p)
            return items

    def write_results(loaded, results):
        with timer.stage("io.write_reports"):
            for ((pcm, wav_fs), path), res in zip(loaded, results):
                res.numpoints = len(pcm)  # report true length, not padding
                name = os.path.basename(path)
                out_path = os.path.join(out_dir, os.path.splitext(name)[0] + ".txt")
                echo = {
                    "minR400": cfg.min_r400, "mindR7500": cfg.min_dr7500,
                    "deadfreq": cfg.dead_freq, "pointsperloop": 100000,
                    "triggerrange": list(cfg.trigger_range),
                }
                write_report(out_path, res, path, [0, -1], echo, cfg,
                             diagnostics=diagnostics)
                entry = {
                    "status": "done", "rows": len(res.time),
                    "decode_status": res.status, "output": out_path,
                    "wire": res.wire, "finished_at": time.time(),
                }
                if res.overflow:
                    entry["overflow"] = res.overflow  # clipped decode
                manifest["files"][name] = entry
        _save_manifest(out_dir, manifest)

    # software pipeline: while batch k computes on device, batch k-1 is
    # fetched + reported and batch k+1's WAVs are read (the device never
    # waits on host IO between batches).  One thread loads the next batch;
    # the readers it hands the batch's files to are a pool of their own, so
    # its waits on them never hold a thread they need.  Both are joined
    # before the call returns.
    n_readers = min(max(map(len, batches), default=1), READERS, os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=1) as executor, \
            ThreadPoolExecutor(max_workers=n_readers,
                               thread_name_prefix="archive-reader") as readers:
        inflight = None  # (out_tree, ctx, loaded)
        pending = executor.submit(load_batch, batches[0]) if batches else None
        for bi, paths in enumerate(batches):
            with timer.stage("io.wait_reader"):
                loaded = pending.result()
            pending = (executor.submit(load_batch, batches[bi + 1])
                       if bi + 1 < len(batches) else None)

            # quarantine unreadable files (failure isolation: a corrupt drop
            # must not abort a 1000-drop job)
            bad = [(d, p) for d, p in loaded if isinstance(d, Exception)]
            for err, path in bad:
                manifest["files"][os.path.basename(path)] = {
                    "status": "failed", "error": repr(err),
                    "finished_at": time.time(),
                }
            loaded = [(d, p) for d, p in loaded if not isinstance(d, Exception)]
            if not loaded:
                _save_manifest(out_dir, manifest)
                continue

            with timer.stage("pad_batch"):
                fs = loaded[0][0][1]
                bucket_n = int(np.ceil(max(len(x[0][0]) for x in loaded)
                                       / (BUCKET_SECONDS * fs))) * BUCKET_SECONDS * int(fs)
                pcms = np.zeros((len(loaded), bucket_n), dtype=loaded[0][0][0].dtype)
                for i, ((pcm, _), _) in enumerate(loaded):
                    pcms[i, : len(pcm)] = pcm[:bucket_n]

            with timer.stage("device.dispatch_batch"):
                lengths = [min(len(x[0][0]), bucket_n) for x in loaded]
                out, ctx = dispatch_batch(pcms, fs, config=cfg, device=device, mesh=mesh,
                                          lengths=lengths, wire=wire)
            if inflight is not None:
                p_out, p_ctx, p_loaded, p_pcms, p_lens, p_fs = inflight
                with timer.stage("device.fetch_batch"):
                    results = finish_dispatched(p_out, p_ctx)
                    results = retry_lossy_rows(results, p_pcms, p_fs,
                                               config=cfg, device=device, mesh=mesh,
                                               lengths=p_lens)
                write_results(p_loaded, results)
            inflight = (out, ctx, loaded, pcms, lengths, fs)

    if inflight is not None:
        p_out, p_ctx, p_loaded, p_pcms, p_lens, p_fs = inflight
        with timer.stage("device.fetch_batch"):
            results = finish_dispatched(p_out, p_ctx)
            results = retry_lossy_rows(results, p_pcms, p_fs, config=cfg,
                                       device=device, mesh=mesh, lengths=p_lens)
        write_results(p_loaded, results)

    manifest["stage_times"] = {k: v for k, v in timer.as_dict().items()
                               if k in MANIFEST_STAGES}
    cache_after = _cache_counts(devices)
    manifest["program_cache"] = dict(
        {k: cache_after[k] - cache_before[k] for k in CACHE_COUNTS},
        held_bytes=cache_after["held_bytes"])
    _save_manifest(out_dir, manifest)
    return manifest
