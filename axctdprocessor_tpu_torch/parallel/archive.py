"""Archive reprocessing: decode a corpus of WAV drops in batches, on one device
or with every batch data-parallel over a mesh (port of
axctdprocessor_tpu.parallel.archive).

Design:

* **length bucketing** — drops are grouped by sample rate and padded length
  (rounded up to a bucket granularity) so each bucket has one shape and pads
  little;
* **host/device pipelining** — while the device decodes batch k, two
  background threads read + condition batch k+1's WAVs, and batch k-1 is
  fetched and its reports written (``batch.dispatch_batch`` queues a batch
  and the copy of its result without waiting for the device; the copy runs
  on a side stream behind its own batch only, so ``finish_dispatched`` of
  batch k-1 does not wait for batch k);
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

from ..models.engine import resolve_device
from ..utils.config import resolve_settings
from ..utils.profiling import StageTimer
from ..utils.report import write_report
from ..utils.wavio import read_wav
from .batch import dispatch_batch, finish_dispatched, retry_lossy_rows

BUCKET_SECONDS = 60  # pad each drop up to a whole minute bucket


def _manifest_path(out_dir: str) -> str:
    return os.path.join(out_dir, "manifest.json")


def _load_manifest(out_dir: str) -> dict:
    path = _manifest_path(out_dir)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"files": {}}


def _save_manifest(out_dir: str, manifest: dict) -> None:
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


def reprocess_corpus(wav_paths: list[str], out_dir: str,
                     settings: dict | None = None, compat: str = "strict",
                     *, device="cuda", mesh=None, batch_size: int = 8,
                     resume: bool = True, timer: StageTimer | None = None,
                     wire: str = "auto", diagnostics: bool = False) -> dict:
    """Decode every WAV on `device` into `out_dir`/<name>.txt; returns the
    manifest.  Asking for a GPU that is not there raises before any work.
    With a `mesh` (``parallel.mesh.make_mesh``) each batch runs data-parallel
    over its ``dp`` axis (``batch.dispatch_batch``) and `device` is not read."""
    if mesh is None:
        device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    cfg = resolve_settings(settings, compat=compat)
    timer = timer or StageTimer()
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

    executor = ThreadPoolExecutor(max_workers=2)

    def load_batch(paths):
        # Per-file loading: one unreadable or odd-format file is isolated
        # (recorded in the manifest), never demotes or aborts the batch.
        # Raw int16 ships at half the bytes and conditions on device, but
        # a batch must be dtype-uniform — if any file needs the float
        # path, the raw rows are host-conditioned to match (same raw-int
        # DC/peak statistics as utils.wavio.read_wav).
        with timer.stage("io.read_wavs"):
            from ..utils.wavio import read_wav_raw16

            items = []
            any_float = False
            for p in paths:
                try:
                    r = read_wav_raw16(p)
                    if r is None:
                        r = _read_and_condition(p)
                        any_float = True
                except Exception as e:
                    r = e
                items.append((r, p))
            if any_float:
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
    # waits on host IO between batches)
    inflight = None  # (out_tree, ctx, loaded)
    pending = executor.submit(load_batch, batches[0]) if batches else None
    for bi, paths in enumerate(batches):
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

    executor.shutdown(wait=False)
    manifest["stage_times"] = timer.as_dict()
    _save_manifest(out_dir, manifest)
    return manifest
