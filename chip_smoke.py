"""On-card smoke run of the PyTorch port (axctdprocessor_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one line each or more (any failure raises and exits non-zero):

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   no GPU -> exit 1 before anything else;
1. build the hand-written CUDA kernels (``tone_ratios.cu``, ``probe.cu`` and
   ``chain.cu``, one extension) and the wire encoders' C library from the
   sources in the checkout (both into
   ``axctdprocessor_tpu_torch/_build/``), time the builds and say which
   encoder runs; then synthesize the drops once: the 600 s bench drop
   (simulator seed 11) as an int16 WAV, and the bench's 64 x 60 s int16
   archive batch;
2. the kernel against its plain PyTorch version on the card, rtol = atol =
   2e-4 with equal NaN positions (the Pallas kernel's own test tolerance):
   a 600 s 44.1 kHz tone-plus-noise signal, a length that is no multiple of
   the stride, a zero-padded tail, one drop of 120 s and of 300 s as the
   monolithic decode pads it (15 s buckets), a 16 kHz case, a 22.05 kHz case
   (stride 882: tiles not 16-byte aligned), a batch of 3 rows whose n is no
   multiple of 4, the 600 s bench drop as the lossy-wire paths hand it to
   the kernel (encoded on the host at int8 and at int4, unpacked and
   conditioned on the card), then the batch path's input (the conditioned
   archive batch) as B = 8 and B = 64 rows of 60 s; each batch row bitwise
   equal to the 1-D kernel; the launcher's plan (the extension's
   ``tone_plan``) holds the table resident at every one of these rates,
   and takes a smaller block shape on a grid under one wave of the SMs
   (one drop of 60, 120 or 300 s: a small shape; 600 s, 8 and 64 rows: the
   standard one); the launcher's record (``tone_last_launch``) names the
   plan's instance, and ``tone_ratios`` forced to every block shape gives
   the same bits.  Then the windows whose table it streams through the
   copy ring: 88.2 kHz (8,820 / 3,528) and 96 kHz (9,600 / 3,840), 60 s as
   1 row (a small shape) and 8 rows, through ``tone_ratios`` and
   ``tone_powers`` (every block shape bit-equal, the resident (8, 2) at
   88.2 kHz among them).  Per shape: median CUDA-event times per call over
   20 runs of 10 back-to-back calls after a warm-up, kernel, plain and (at
   a small shape) the standard shape in turns; the bound (the
   bytes at 3.35 TB/s against the flop at 66.9 TFLOP/s) and the share of
   it the kernel reaches; and, for reference only, one ``torch.matmul`` of
   the tile view by the segment matrix (the DFT core alone);
2b. the chain kernels (``chain_walk_segments``, the bit-edge chain, through
   its wrapper ``chain_enumerate_strided``; ``chain_walk_frames``, frame
   sync's chain, through ``chain_enumerate_frames``) against their plain
   versions on the card, bit for bit: every call that the 600 s drop's
   monolithic, segmented and time-sharded (dp 1 x sp 4) decodes, 4 archive
   rows time-sharded on dp 2 x sp 2, ``decode_batch`` of 8 and of 64 archive
   rows and 2 x 8 rows through the pipeline hand them (recorded as the paths
   run), each row of a recorded call equal to its 1-D call, each frame walk
   also equal to ``chain_enumerate`` (jump tables and ``chain_walk``, the
   general map's kernel) on the same table; then the edge cases (k = 1, 2;
   k <= first; k = first; k no multiple of first; a dead table; early stalls;
   rows of different true lengths with padded tails; ``chain_walk`` on
   general maps with a dead row), the segment walk's seams (a stride onto
   every segment boundary; fixed points on a segment's first and last entry
   and on a tile's last; m < one segment; m no multiple of a segment; k
   longer than the chain; a dead row beside live ones; 64 rows of different
   true lengths) and the frame walk's (a stride of 32 onto every segment and
   tile boundary; fixed points on a warp's first and last lane and a tile's
   last entry; cap < 32; cap no multiple of a segment; a dead row (no
   accept) beside live ones; accepts overflowing cap; k = 1; k longer than
   the chain; 64 rows of different kept accepts), each row also equal to its
   1-D call.  Per shape the median CUDA-event times of kernel and plain in
   turns (5 runs of 2 calls), the bytes bound and the share of it; for the
   frame walk also the jump-table walk it replaced (jump tables +
   ``chain_walk``) in the same turns and the time of an empty kernel (the launch floor).
   ``--only-chain`` runs the build and this phase alone and exits 3 without
   result lines (a development run); then ``chain_walk`` alone (the general
   map's walk, on no path) on the jump tables of the 600 s decode's largest
   frame-sync table, bit for bit its plain version, timed;
2c. the FFT: whether cuFFT filters a row of a (B, nfft) call bit for bit as
   the row alone (the demod filter: ``rfft``, the response, ``irfft``), at
   nfft 2^20 (the 600 s drop cut into its 26 haloed segments) for B = 1, 2,
   4, 8, 26 and at the 60 s row's nfft (the conditioned archive rows) for
   B = 8, 64; the ``rfft`` alone; in fixed chunks of 2, 4 and 8 rows against
   the row alone in a padded chunk; one call against row by row, timed; then
   the port's rule (``engine.FFT_ROWS_PER_CALL["cuda"]`` rows a call) must hold:
   every row of ``engine.apply_response`` over a batch equal to the 1-D call;
2d. the demod front end's kernels (``tone_powers``, the tone kernel's raw
   powers, and ``probe_at``, the per-bit probe) against their plain versions
   (rtol = atol = 2e-4) at every call that the 600 s drop's monolithic,
   segmented (groups of 4), prestaged ``fused`` (26 segments in one pass),
   time-sharded (dp 1 x sp 4) and streamed (1 s float blocks) decodes and
   ``decode_batch`` of 8 and 64 archive rows hand them (recorded as the
   paths run), each row of a batched call bit-equal to its 1-D call, each
   ``tone_powers`` call bit-equal at every block shape of the kernel (the
   extension's ``tone_powers_shapes()``) to the launcher's choice; the edge
   cases (starts at 0, at L - window and
   clamped beyond both ends, rows one window long, K = 0 and no window
   launching nothing, rows that are views of a wider tensor; the probe's
   runs: unsorted starts, runs whose span overflows the staged buffer, a
   long tail of one repeated start, one start clamped to L - window after
   live edges, K no multiple of the run, K below it, each probe also
   bit-equal to its frame in a staged run of its own; the geometry for the
   engine's windows: the standard one at 39 and 50 samples, another above
   that stages a run of bit edges at 88.2 and 96 kHz); ``probe_at`` at 88.2
   and 96 kHz on the calls of ``decode_batch`` of 8 rows of 60 s at the
   native rate: the launcher's geometry for the window (its record,
   ``probe_last_launch``, names it) stages at least 0.95 of the runs
   (computed from the starts), every row bit-equal to its 1-D call, every
   geometry forced (the standard one among them) bit-equal, timed in turns
   with the standard geometry, the plain version and ``frames @ trig``; at the first call of
   each path the times of kernel, plain version and the library product
   (``frames @ trig`` of the gathered frames; the tile view times the
   segment matrix) in turns, for ``tone_powers`` also the standard block
   shape, the bound and the share of it;
2e. the batched front end against its 1-D calls, bit for bit: the 600 s
   drop's 26 segments in one pass and in groups of 4 against each segment
   alone (every output); from the raw int16 rows, the 64 archive rows
   conditioned as one batch against each row conditioned alone, then
   through ``FusedDecoder.stage1`` in one pass against each row alone;
   ``--only-frontend`` runs the build and phases 2c-2e alone and exits 3
   without result lines (a development run);
3. the monolithic path end to end: the 600 s WAV through
   ``decode_wav(device="cuda", mode="monolithic")``; held to the
   simulator's truth and to the CPU decode of the same WAV (and of the
   50 s default drop); the kernel's launch count is read around the first
   decode only;
4. a 42 s drop at 88.2 kHz (on-card decimation), metadata against truth;
5. the port's CLI in a subprocess on the 600 s WAV with its defaults (the
   device engine on the card; ``"auto"``: the segmented engine), and the
   same command with no card visible, which must fail;
6. the segmented engine: the 600 s WAV through ``decode_wav`` (``"auto"``
   routes it there), the same gates, agreement with the monolithic decode,
   warm walls and host syncs; the drop staged on the card at each wire
   (int16, int8, int4): every group byte for byte ``_chunk_host``'s, ``dc``
   and ``peak`` bit for bit the host's rule for the wire, and a warm decode
   opens ``stage_device`` once and no ``program.*`` span (no build, eager
   run or capture);
7. prestaged: ``prestage_waveform(wire="int8")``, its groups and
   statistics held to the host as in phase 6, then ``decode()``, warm
   walls, sustained throughput of 8 queued decodes, ``fused=True`` equal;
8. the stream decoder fed the 600 s drop in 1 s float blocks: ``finalize()``
   equal to the offline segmented decode of the same samples;
9. the batch path: the archive batch through ``decode_batch`` as one batch
   of 64 and as 8 of 8; every row's status and serial, one kernel launch
   per call, walls, peak device memory and host syncs;
9a. the pipeline: the 64 rows as 8 batches of 8 through
   ``decode_batches_pipelined``; every row equal to phase 9's 8 x 8 row
   (hexframes, metadata, ``time``), one kernel launch per batch, the warm
   wall in turns with ``decode_batch`` batch by batch;
9b. the archive runner: the 64 rows as int16 WAVs plus one truncated file
   through ``reprocess_corpus(batch_size=8)``: 64 ``done``, 1 ``failed``,
   every report's bytes equal to ``write_report`` of phase 9a's row, one
   kernel launch per batch; ``resume=True`` decodes nothing (it opens no
   span but ``plan_batches`` and ``io.save_manifest``); wall, drops
   per second and stage times; then the CLI's ``--corpus`` in a subprocess;
9c. the host parity engine: the CLI with ``--engine parity`` on the 50 s
   default drop in a subprocess, and hexframe agreement >= 0.99 of the
   card's monolithic decode with the parity decode, on that drop and on the
   600 s drop (the bench's gate, ``bench.py:207-215``);
9d. the multi-device paths on the one card: every mesh is built from an
   explicit device list that repeats ``cuda:0``.  The 600 s drop as a (1, n)
   int16 batch through ``decode_batch_timesharded`` on ``{"dp": 1, "sp": 4}``
   (phase 3's gates, agreement with phase 3's monolithic decode >= 0.99, no
   ``tone_ratios`` launch: the time-sharded front end takes raw powers
   (``tone_powers``) and smooths the gathered series, as the JAX one; warm
   walls, host syncs, peak memory); 4 archive rows on
   ``{"dp": 2, "sp": 2}``; the first 16 archive rows through
   ``decode_batch(mesh={"dp": 2})``, every row equal to phase 9's, one
   kernel launch per ``dp`` run; 2 batches of 8 through
   ``decode_batches_pipelined(devices=[cuda:0, cuda:0])``, rows equal to
   phase 9a's;
9e. the lossy wires (int8, noise-shaped int4, the int8 retry) on the card:
   ``unpack_int4`` and ``condition_integer`` bit-equal to the CPU on the
   host's encodings of the 600 s drop, an odd length and 8
   archive rows; the 600 s WAV through ``decode_wav(wire=w, mode=m)`` for
   the three wires and both modes (phase 3's gates, ``res.wire == w``,
   agreement with the int16 decode >= 0.99; warm walls in turns, the
   host's encode and upload-building times, H2D bytes and the time of one
   pinned copy of that size, peak device memory; at int4 the row-cap bit
   of ``overflow`` is reported and allowed, no other bit at any wire); the
   64 archive rows through ``decode_batch`` 8 x 8 at the three wires with
   ``lossy_retry=True`` (every row status 2 with the true serial, the rows
   decoded again at int8 and the kernel launches they cost, agreement with
   the int16 rows, three walls per wire in turns), the same at int4 through
   ``decode_batches_pipelined`` and ``reprocess_corpus`` (rows and report
   bytes equal to ``decode_batch``'s, the manifest's wire per file); one
   drop that collapses at int4 on the card through ``decode_waveform`` with
   the retry (int8, status 2, two kernel launches) and without (int4,
   degenerate); the CLI's ``--wire int4`` against the in-process decode;
9f. ``iir.sosfilt`` (the parallel scan form, float64) on one second of the
   600 s drop on the card against ``iir.sosfilt_fft`` and its CPU run;
9g. the archive at the BASELINE's scale: ``tools/corpus_1000.py``'s corpus
   (1,000 files, 995 drops of 45-120 s at 44.1 kHz and 60 s at 88.2 kHz and
   5 corrupt files; 200 files where the free disk is under twice its size,
   with the reason printed) built in the temporary directory and removed
   after; a fresh ``reprocess_corpus(batch_size=8)`` on the card held to the
   tool's gates (done + failed == N, exactly the corrupt files failed, every
   done drop at status 2 with the truth's serial, probe code and max depth
   and hexframes in the truth > 0.97), with its wall, drops per second,
   realtime factor, stage times and launches per batch; the peak device
   memory of a batch of 120 s drops; a second run with every
   ``tone_ratios``, ``probe_at``, ``chain_walk_segments`` and
   ``chain_walk_frames`` call checked as it is made against its plain
   version (floats rtol = atol = 2e-4, integers bit for bit), each row of a
   batched call against its 1-D call, every report byte-equal to the first
   run's; a resume from the manifest cut to half its done entries, which
   must decode exactly the other half.  Then 8 rows of 60 s at 88.2 kHz
   through ``decode_batch`` at the native rate (the streamed table) against
   ``decode_batch(device="cpu")`` of the same rows (hexframes, metadata and
   every integer field of the packed result equal), and the share of that
   decode's ``probe_at`` runs its geometry stages;
   ``--only-corpus`` runs the build, phase 2's high-rate cases and this phase
   and exits 3 without result lines (a development run);
9h. the cached programs (``models/programs.py``: one per static shape, run
   eagerly at its first call, captured as a CUDA graph at its second and
   replayed after) against the eager module (the program's own
   ``FusedDecoder`` / ``SegmentedDecoder`` forward on the same static
   input), bit for bit on every field of the packed vector or matrix: one
   drop of 60 s, one of 300 s and the 600 s drop forced monolithic, each as
   three drops of one 15 s bucket with different seeds and the first again,
   at int16 and at int8; 8 and 64 rows of 60 s as three batches with their
   own row orders and true lengths, then two of them interleaved (dispatch
   k, dispatch k+1, finish k, finish k+1), at int16 and int8; three 600 s
   drops prestaged ``fused`` (each its own program: three dispatches in a
   row, then 8 queued, 8 distinct outputs); every kernel's launches per
   call the same whether eager, captured or replayed; the walls of the
   first (eager) call, the capture call and the replays; host syncs of a
   replayed decode (at most two for a single drop's fetch, the
   ``device_wait`` synchronize and the copy; one a batch's copy); warm
   walls eager (``_eager_programs``)
   against program in turns, medians of 5, on the six shapes; the cuFFT
   plan cache's size against its bound; the memory the program cache holds
   (also after phases 9 and 9g), which must be within its bound.  The
   segmented engine's programs: the 600 s drop through
   ``decode_waveform_segmented``, then a longer (655 s) and a shorter (575
   s) drop of its 28-segment bucket, each packed vector bit for bit the
   group program's module's eager forward (the shorter one's assemble
   replays over rows that held the longer one's segments); the drop
   prestaged group by group (int8: three dispatches, then 8 queued); a
   stream pinned to the drop's bucket fed in 1 s blocks with a
   ``results()`` snapshot at each new segment: its constructor captures both
   programs and nothing is captured after it, every snapshot and
   ``finalize()`` bit for bit the module's eager assemble of the segments
   each decoded alone; the pipeline's stage-1 and back-half programs on the
   64 rows as batches of 8 and of 64 in three row orders, every matrix bit
   for bit the modules' eager ``stage1`` and ``back_half``.  Warm walls in
   turns also for the segmented decode, the group-by-group prestaged
   decode, a stream snapshot, the pipeline 8 x 8 and ``decode_batch`` 8 x 8.  ``--only-programs`` runs the build, this
   phase and phase 10's part of it and exits 3 without result lines (a
   development run);
10. ``torch.profiler`` last, after every wall (a process that has run the
   profiler launches more slowly from then on): one segmented, one
   prestaged ``fused``, one monolithic and one time-sharded decode of the
   600 s drop and one batch of 8 of the archive rows (launches, device idle
   share, the upload), one pipelined run of 2 x 8,
   then the tone-ratio kernel's device time at each phase-2 shape (at a
   small block shape also the standard one's; the DFT core's product) and the
   chain kernels' at each phase-2b shape (``chain_walk_segments``: the sum of
   its three kernels per call; ``chain_walk_frames``: its kernel, and its whole
   call with the flags' fill, beside the device time of the jump tables'
   gathers and of the jump-table walk's whole call on the same table, and of an empty
   kernel); no jump table is built in those decodes (``jump_levels`` is
   counted), and one frame-sync call's launches are counted; ``chain_walk``
   alone, and ``tone_powers`` and ``probe_at`` at each phase-2d shape
   (``tone_powers`` also at every block shape, and the kernel the trace
   names must be the shape and table the extension's ``tone_plan`` reports);
   one 88.2 kHz batch of 8 x 60 s through ``decode_batch``, the streamed
   kernel's device time at phase 2's high-rate shapes beside its bound and
   the DFT core's product, and ``probe_at``'s at phase 2d's 88.2 and 96 kHz
   calls, at the launcher's geometry and the standard one, beside
   ``frames @ trig``.  Then a warm decode of the 600 s drop monolithic, of
   ``decode_batch`` of 8 x 60 s and of the prestaged ``fused`` drop, eager
   and through its program: the host's launch calls (kernel launches, graph
   launches, copies, fills) beside the device's kernels (the same in both;
   at most 10 host launch calls through the program for the first two),
   device busy time and idle share; the same for the segmented decode of
   the 600 s drop (at most 150 host launch calls through its programs), its
   group-by-group prestaged decode, a stream snapshot and the pipeline of 8
   batches of 8 (at most 30 host launch calls a batch).  Every profile of a decode counts the
   host's launch calls and the device's kernels, those under a graph
   launch's correlation id apart.

A stand-in that records or checks a wrapper's calls while a path runs
(phases 2b, 2d, 9g, 10) runs every program eagerly meanwhile: a replay calls
no wrapper, and a capture must not run a stand-in.  Each path is driven
with every kernel's launch count set to 0 just before and read just after
(a replay adds its capture's counts: each kernel counts one launch per
replay, as it did eagerly; each chain kernel and ``probe_at`` must have
launched on every path, exactly one of ``tone_ratios`` and ``tone_powers``, the streamed
table on the 88.2 kHz batch and on no other path, and ``chain_walk``, the
general map's walk, never).  At the end neither jax nor any module of the JAX
package (``axctdprocessor_tpu``) may be loaded.  Then come the line
``{"kernels": [...]}`` (``tone_ratios``, ``tone_ratios_streamed``, ``tone_powers``, ``probe_at``,
``chain_walk_segments``, ``chain_walk_frames`` and ``chain_walk``: each
kernel's launches on every path; per shape: times, bound and share of
bound), the
card's name and power limit, and, last, ``{"ok": true, "device": {...}}``.
Temporary WAVs live in a directory inside the checkout that is removed at
the end.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
RTOL = ATOL = 2e-4  # tests/test_pallas_kernels.py:36, the Pallas kernel's own bar
KERNEL_SOURCE = "axctdprocessor_tpu_torch/ops/kernels/tone_ratios.cu"
REPLACES = "axctdprocessor_tpu/ops/pallas/tonepower.py:110"
CHAIN_SOURCE = "axctdprocessor_tpu_torch/ops/kernels/chain.cu"
# the chain kernels replace lax.scan and fused XLA of the JAX package, not
# Pallas kernels: the lines of the JAX code each one stands for, and the
# wrapper in ops/chain.py that launches it and counts its launches
CHAIN_REPLACES = {
    "chain_walk_segments": "axctdprocessor_tpu/ops/chain.py:248-329",
    "chain_walk_frames": "axctdprocessor_tpu/ops/chain.py:197-245",
}
CHAIN_WRAPPERS = {"chain_walk_segments": "chain_enumerate_strided",
                  "chain_walk_frames": "chain_enumerate_frames"}
# the kernels' names in a profiler trace (chain_walk_segments launches three)
CHAIN_IN_TRACE = {"chain_walk_segments": "chain_segments_",
                  "chain_walk_frames": "chain_frames_kernel"}
# the demod front end's kernels over a batch: the raw-powers variant of the
# tone kernel and the per-bit probe.  The JAX package runs both as plain XLA
# under jax.vmap (goertzel.framed_tone_power_tiled and tone_power_at in
# _segment_program_grouped, _resident_program, _batched_stage1, _batched_fused)
FRONTEND_SOURCE = {"tone_powers": KERNEL_SOURCE,
                   "probe_at": "axctdprocessor_tpu_torch/ops/kernels/probe.cu"}
FRONTEND_REPLACES = {"tone_powers": "axctdprocessor_tpu/ops/goertzel.py:55-88",
                     "probe_at": "axctdprocessor_tpu/ops/goertzel.py:91-110"}
FRONTEND_IN_TRACE = {"tone_powers": "tone_ratios_kernel", "probe_at": "probe_run_kernel"}
# the tone kernel with its table streamed through the copy ring (windows
# whose table does not fit beside the ring: 88.2 and 96 kHz rows at their
# native rate), launched by tone_ratios and tone_powers; counted apart
STREAMED = "tone_ratios_streamed"
KERNELS = ("tone_ratios", STREAMED) + tuple(FRONTEND_REPLACES) + tuple(CHAIN_REPLACES)
PATH_LAUNCHES: dict = {}  # path -> {kernel: launches}, every path this run drives


T0 = time.perf_counter()


def _kernel_fns() -> dict:
    from axctdprocessor_tpu_torch.ops import chain, goertzel, tonepower

    return {"tone_ratios": tonepower.tone_ratios, "tone_powers": tonepower.tone_powers,
            "probe_at": goertzel.probe_at,
            **{name: getattr(chain, wrapper) for name, wrapper in CHAIN_WRAPPERS.items()}}


def zero_counts() -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    from axctdprocessor_tpu_torch.ops import chain, tonepower

    for fn in _kernel_fns().values():
        fn.launches = 0
    chain.chain_walk.launches = 0
    tonepower.tone_ratios.streamed_launches = tonepower.tone_powers.streamed_launches = 0


def read_counts(path: str, high_rate: bool = False) -> dict:
    """Every kernel's launch count just after `path` ran; every path walks
    the bit-edge chain, probes its bits and frame-syncs, so each chain kernel
    and ``probe_at`` must have been launched at least once, and the general
    map's walk (jump tables and ``chain_walk``) never; the tone powers come
    from exactly one of the tone kernel's two forms (the ratios on the
    monolithic and batch paths, the raw powers on the segmented, prestaged,
    stream and time-sharded ones).  The tone kernel streams its table on a
    `high_rate` path (rows above 50 kHz at their native rate) and on no
    other: every other path launches the resident-table instances."""
    from axctdprocessor_tpu_torch.ops import chain, tonepower

    got = {name: fn.launches for name, fn in _kernel_fns().items()}
    got[STREAMED] = (tonepower.tone_ratios.streamed_launches
                     + tonepower.tone_powers.streamed_launches)
    assert (got[STREAMED] > 0) == high_rate, f"{path}: streamed-table launches {got}"
    missing = [k for k in ("probe_at",) + tuple(CHAIN_REPLACES) if got[k] < 1]
    assert not missing, f"{path}: no launch of {missing}: {got}"
    assert (got["tone_ratios"] > 0) != (got["tone_powers"] > 0), f"{path}: tone kernels {got}"
    assert chain.chain_walk.launches == 0, f"{path}: frame sync launched chain_walk"
    PATH_LAUNCHES[path] = got
    return got


def counts_text(got: dict) -> str:
    return ", ".join(f"{k} {got[k]}" for k in KERNELS)


def log(msg: str) -> None:
    print(msg, flush=True)


def mark(phase: str) -> None:
    """One line per finished phase with the seconds since the script began,
    so that a run shows where its time went."""
    log(f"[t] phase {phase} done at {time.perf_counter() - T0:.0f} s")


def phase0_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    # a float32 reference in full float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"[0] card {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} "
        f"| devices {torch.cuda.device_count()} | tf32 off")
    return smi, kind


def phase1_build() -> None:
    from axctdprocessor_tpu_torch.ops import kernels
    from axctdprocessor_tpu_torch.utils import native

    t0 = time.perf_counter()
    kernels.extension()
    dt = time.perf_counter() - t0
    log(f"[1] built the kernels (one extension: {KERNEL_SOURCE}, {FRONTEND_SOURCE['probe_at']}, "
        f"{CHAIN_SOURCE}; sm_90a) in "
        f"{dt:.1f} s")
    t0 = time.perf_counter()
    lib = native.get_library()
    dt = time.perf_counter() - t0
    log("[1] wire encoders: " + (
        f"the C library ({os.path.relpath(native.LIB_PATH, ROOT)}, built from "
        f"{os.path.relpath(native.SOURCE, ROOT)} in {dt:.1f} s)" if lib is not None
        else "numpy (no g++, or AXCTD_NO_NATIVE set)"))


def archive_batch() -> dict:
    """The bench's archive batch (``bench.py:132-150``): one simulated 60 s
    drop (seed 21, profile at 40 s) plus independent noise per row (rng
    seed 7), 64 int16 rows."""
    from axctdprocessor_tpu_torch.models import simulator

    rng = np.random.default_rng(7)
    bspec = simulator.SimSpec(duration=60.0, profile_start=40.0, seed=21)
    bpcm, btruth = simulator.synthesize(bspec)
    base = np.round(bpcm * (28000 / np.max(np.abs(bpcm)))).astype(np.int16)
    rows = np.stack([np.clip(base + rng.integers(-300, 300, len(base)), -32768, 32767)
                     .astype(np.int16) for _ in range(64)])
    return dict(batch=rows, batch_truth=btruth, batch_fs=bspec.fs)


def phase1_drops(tmp: str) -> dict:
    """The 600 s bench drop as a WAV (``bench.py:104``) and the bench's
    archive batch."""
    from axctdprocessor_tpu_torch.models import simulator

    t0 = time.perf_counter()
    spec = simulator.SimSpec(duration=600.0, profile_start=33.0, seed=11)
    pcm, truth = simulator.synthesize(spec)
    wav = os.path.join(tmp, "bench_600s.wav")
    simulator.write_wav(wav, pcm, spec.fs)
    del pcm
    batch = archive_batch()
    log(f"[1] synthesized the 600 s bench drop and the 64 x 60 s archive batch in "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(wav=wav, truth=truth, fs=spec.fs, **batch)


@contextlib.contextmanager
def count_syncs():
    """Counts the operations that make the host wait for the card
    (``torch.cuda.set_sync_debug_mode``; it sees PyTorch's own waits, not
    the driver's)."""
    box = {}
    # switched on outside the recording: the first switch in a process
    # raises one warning of its own
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            yield box
        finally:
            torch.cuda.set_sync_debug_mode("default")
            box["n"] = sum("synchroniz" in str(w.message) for w in caught)


def _launch_kind(name: str) -> str | None:
    """The kind of work a host-side CUDA runtime or driver call of this name
    puts on the card's queue (a graph launch queues the graph's kernels,
    copies and fills at once), or None."""
    if "GraphLaunch" in name:
        return "graph launches"
    if "Launch" in name and "Kernel" in name:
        return "kernel launches"
    if "Memcpy" in name:
        return "copies"
    if "Memset" in name:
        return "fills"
    return None


def launch_counts(events, skip=frozenset()) -> dict:
    """From a profile's events, less those of the correlation ids in `skip`:
    the host's launch calls by kind (kernel launches, graph launches, copies,
    fills) and in all, and the device's kernels, copies and fills in all and
    those under a graph launch's correlation id (the graph's own)."""
    from torch.autograd import DeviceType

    out = {k: 0 for k in ("kernel launches", "graph launches", "copies", "fills")}
    graphs = set()
    events = [e for e in events if e.id not in skip]
    for e in events:
        kind = _launch_kind(e.name) if e.device_type == DeviceType.CPU else None
        if kind:
            out[kind] += 1
            if kind == "graph launches":
                graphs.add(e.id)
    out["host launch calls"] = sum(out.values())
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
    out.update({"device kernels": len(kernels),
                "device copies and fills": len(device) - len(kernels),
                "device kernels of graph launches": sum(e.id in graphs for e in kernels)})
    return out


def launches_text(c: dict) -> str:
    return (f"host launch calls {c['host launch calls']} (kernel launches "
            f"{c['kernel launches']}, graph launches {c['graph launches']}, copies "
            f"{c['copies']}, fills {c['fills']}), device kernels {c['device kernels']} "
            f"({c['device kernels of graph launches']} of them under a graph launch)")


def profile_run(fn) -> str:
    """One run of `fn` under ``torch.profiler``: wall, the host's launch
    calls and the device's kernels (``launch_counts``), device busy time
    (union of device activity) and idle share, and the host-to-device
    copies by kind."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    launches = launches_text(launch_counts(events))
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -1e30
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    h2d = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and "HtoD" in e.name:
            n, us = h2d.get(e.name, (0, 0.0))
            h2d[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not spans:
        return (f"profiled wall {wall_us / 1e3:.1f} ms, {launches}; device time "
                "not measured")
    return (f"profiled wall {wall_us / 1e3:.1f} ms, {launches}, device busy "
            f"{busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}, H2D "
            + ("; ".join(f"{k}: {n} copies {us / 1e3:.2f} ms" for k, (n, us) in h2d.items())
               or "none"))


HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak memory rate
F32_FLOP_PER_S = 66.9e12   # H100 SXM f32 on the CUDA cores


def _event_ms(fn, calls: int = 1) -> float:
    """CUDA-event time per call over `calls` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _time_pair(kernel, plain, runs: int = 20, calls: int = 10) -> tuple[float, float]:
    """Median CUDA-event times per call of `kernel` and `plain` over `runs`
    runs of `calls` back-to-back calls each, in turns, after a warm-up."""
    ms = _time_turns({"kernel": kernel, "plain": plain}, runs, calls)
    return ms["kernel"], ms["plain"]


PROFILE_TRIES = 5
LEAD_CYCLES = 100_000  # the lead kernel of a device-time profile: about 50 us of spin
# short profiles, those with no device activity, the profiles of device times
# that missed some device events, the launches, copies and fills the host
# queued in those profiles, and the device events not recorded of them
PROFILES = {"taken": 0, "empty": 0, "incomplete": 0, "queued": 0, "unrecorded": 0}


def _profiled(fn, calls: int = 1, cpu: bool = False, lead: bool = False):
    """``torch.profiler`` over `calls` calls of `fn`, after a warm-up call:
    the card's activity, and the host's if `cpu`; with `lead`, a kernel that
    spins for LEAD_CYCLES is launched first in the profile (the profiler at
    times misses the first device event of a profile: a launch of the
    measured calls then falls behind it).  On the card this profiler at
    times records no device activity at all in a short profile, at any
    point of a process; such a profile is taken again, up to PROFILE_TRIES
    times, and counted in PROFILES.  Returns the last profile taken."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for _ in range(PROFILE_TRIES):
        with profile(activities=activities) as prof:
            if lead:
                torch.cuda._sleep(LEAD_CYCLES)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        PROFILES["taken"] += 1
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            break
        PROFILES["empty"] += 1
    return prof


def _queues_device_work(name: str) -> bool:
    """Whether a host-side CUDA runtime or driver call of this name puts
    work on the card's queue: a kernel launch, a graph launch, a copy or a
    fill (``_launch_kind``)."""
    return _launch_kind(name) is not None


def _complete_device_events(fn, calls: int):
    """The device events of `calls` calls of `fn`, from a profile in which
    every launch, copy and fill the host queued for them (its runtime calls,
    ``_queues_device_work``, after the lead's launch) has its device event,
    matched by correlation id, and no other device event ran but the lead's.
    The profiler at times misses the first device event of a profile (the
    lead's, ``_profiled``) and at times others; a profile that missed one of
    the calls' is taken again, up to PROFILE_TRIES times, and counted in
    PROFILES.  None if no profile was complete."""
    from torch.autograd import DeviceType

    for _ in range(PROFILE_TRIES):
        events = _profiled(fn, calls, cpu=True, lead=True).events()
        queued = sorted((e for e in events
                         if e.device_type == DeviceType.CPU and _queues_device_work(e.name)),
                        key=lambda e: e.time_range.start)
        lead = queued[0].id if queued else None
        wanted = {e.id for e in queued[1:]}
        device = [e for e in events if e.device_type == DeviceType.CUDA and e.id != lead]
        recorded = {e.id for e in device}
        PROFILES["queued"] += len(wanted)
        PROFILES["unrecorded"] += len(wanted - recorded)
        if wanted and recorded == wanted:
            return device
        PROFILES["incomplete"] += 1
    return None


def _device_ms(fn, name: str, calls: int = 20):
    """Device time per call of `fn` in the kernels whose name holds `name`,
    over `calls` calls, from a profile that recorded every device event
    (``_complete_device_events``; None if none did, or no such kernel ran)."""
    events = _complete_device_events(fn, calls)
    total = sum(e.time_range.elapsed_us() for e in events or () if name in e.name)
    return total / calls / 1e3 if total else None


def _bound(rows: int, n: int, window: int, n_win: int) -> tuple[float, str]:
    """The least time the card could take for the kernel's work: each input
    read once (the samples and the (window, 6) table), each output written
    once, against six length-`window` dot products (2 flop per multiply-add)
    plus the box mean and ratios (~30 flop) per window."""
    nbytes = 4 * (rows * n + window * 6 + 2 * rows * n_win)
    flop = rows * n_win * (12 * window + 30)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def _max_err(got, ref, name) -> float:
    errs = []
    for g, r in zip(got, ref):
        g, r = g.cpu().numpy(), r.cpu().numpy()
        assert g.shape == r.shape, name
        assert np.array_equal(np.isnan(g), np.isnan(r)), f"{name}: NaN positions differ"
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL, equal_nan=True, err_msg=name)
        fin = np.isfinite(g)
        errs.append(float(np.max(np.abs(g[fin] - r[fin]))) if fin.any() else 0.0)
    return max(errs)


def _rows_bitwise(xb, got, one_call, name) -> None:
    """Each row of the batch call's outputs `got` bitwise equal to
    `one_call` (the 1-D kernel) on that row."""
    for r in range(xb.shape[0]):
        one = one_call(xb[r])
        for g, o in zip(got, one):
            assert torch.equal(torch.nan_to_num(g[r], nan=7.0), torch.nan_to_num(o, nan=7.0)), \
                f"{name}: row {r} differs from the 1-D kernel"


def _dft_core_ms(x, tm, window: int, stride: int) -> float:
    """One ``torch.matmul`` (f32, TF32 off) of the (n_tiles, stride) tile view
    by the (stride, 18) segment matrix: the DFT core alone, not the same
    function (no shifted adds, magnitudes, box mean or ratios), to show what
    cuBLAS reaches on the same bytes."""
    n = x.shape[-1]
    n_tiles = n // stride
    tiles = x[..., : n_tiles * stride].reshape(-1, stride)
    segs = torch.zeros((3, stride, 6), device=x.device)
    for j in range(3):
        seg = tm[j * stride: min((j + 1) * stride, window)]
        segs[j, : seg.shape[0]] = seg
    seg_mat = segs.permute(1, 0, 2).reshape(stride, 18).contiguous()
    for _ in range(3):
        torch.matmul(tiles, seg_mat)
    return statistics.median(_event_ms(lambda: torch.matmul(tiles, seg_mat), 10)
                             for _ in range(20))


def _tone_signal(fs, n, tail, rng):
    """A 400 + 7500 Hz tone with noise on the card, its last `tail` zeros."""
    t = np.arange(n) / fs
    x = (0.4 * np.sin(2 * np.pi * 400.0 * t) + 0.2 * np.sin(2 * np.pi * 7500.0 * t)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    if tail:
        x[int(n * (1 - tail)):] = 0.0
    return torch.from_numpy(x).to("cuda")


def _kernel_cases(drops: dict) -> list:
    """(name, input on the card, fs) of every shape the kernel is held to;
    built anew by each phase that needs them (the same data each time), so
    that no phase keeps them alive on the card for the next."""
    from axctdprocessor_tpu_torch.models import engine

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def tone_signal(fs, n, tail):
        return _tone_signal(fs, n, tail, rng)

    # the batch path's input is the archive batch conditioned on the card
    cases = [
        ("600 s 44.1 kHz", tone_signal(44100.0, int(600 * 44100), 0.0), 44100.0),
        ("ragged 50 s", tone_signal(44100.0, int(50 * 44100) + 777, 0.0), 44100.0),
        ("zero tail 60 s", tone_signal(44100.0, int(60 * 44100), 0.25), 44100.0),
        # one drop of 120 s and of 300 s as the monolithic decode hands it over
        # (a 15 s bucket, zero-padded): the longest drops "auto" keeps there
        ("120 s drop", tone_signal(44100.0, int(120 * 44100), 0.1), 44100.0),
        ("300 s drop", tone_signal(44100.0, int(300 * 44100), 0.05), 44100.0),
        ("16 kHz 45 s", tone_signal(16000.0, int(45 * 16000), 0.1), 16000.0),
        ("22.05 kHz 120 s (stride 882)", tone_signal(22050.0, int(120 * 22050), 0.1), 22050.0),
        ("batch 3 x (50 s + 777), n % 4 = 1",
         torch.stack([tone_signal(44100.0, int(50 * 44100) + 777, tail)
                      for tail in (0.0, 0.1, 0.3)]), 44100.0),
    ]
    # what the kernel sees on the lossy-wire paths: the 600 s bench drop
    # encoded on the host, then unpacked and conditioned on the card
    from axctdprocessor_tpu_torch.ops import wire as wire_ops
    from axctdprocessor_tpu_torch.utils.wavio import read_wav_raw16

    raw, _ = read_wav_raw16(drops["wav"])
    n_raw = len(raw)
    for w in ("int8", "int4"):
        enc = torch.from_numpy(wire_ops.encode(raw, w)).to(dev)
        cases.append((f"600 s bench drop, {w} wire conditioned on the card",
                      engine.conditioned(enc, torch.full((), n_raw, device=dev))[:n_raw]
                      .contiguous(), 44100.0))
    rows = torch.from_numpy(drops["batch"]).to(dev)
    n = rows.shape[1]
    cond = engine.condition_integer(rows, n, torch.full((rows.shape[0],), n, device=dev))
    return cases + [(f"batch {b} x 60 s (conditioned archive rows)", cond[:b].contiguous(),
                     drops["batch_fs"]) for b in (8, 64)]


def _high_rate_cases() -> list:
    """(name, input on the card, fs) of the windows whose table the tone
    kernel streams through its ring: 88.2 kHz (window 8,820, stride 3,528)
    and 96 kHz (9,600 / 3,840), 60 s as one row and as 8 rows, as the batch
    path hands rows above 50 kHz over at their native rate."""
    rng = np.random.default_rng(1)
    cases = []
    for fs in (88200.0, 96000.0):
        n = int(60 * fs)
        cases.append((f"{fs / 1e3:g} kHz 60 s", _tone_signal(fs, n, 0.1, rng), fs))
        cases.append((f"batch 8 x 60 s at {fs / 1e3:g} kHz",
                      torch.stack([_tone_signal(fs, n, 0.05 * r, rng) for r in range(8)]), fs))
    return cases


def _table(fs: float):
    from axctdprocessor_tpu_torch.ops import goertzel

    window, stride = int(fs / 10), int(round(fs / 25))
    tm = torch.from_numpy(goertzel.tone_matrix(
        window, [400.0, 7500.0, 3000.0], fs, dtype=np.float32)).cuda()
    return window, stride, tm


def _nan7(t):
    return torch.nan_to_num(t, nan=7.0)


def _ratios_at_every_shape(name, xd, tm, window: int, stride: int, got) -> dict:
    """Called right after ``got = tonepower.tone_ratios(xd, ...)``, with no
    tone launch between: the instance the launcher recorded for that call
    must be the plan's, and ``tone_ratios`` forced through the extension to
    every block shape of the kernel must give ``got`` bit for bit (NaN where
    it has NaN).  Returns the plan as a record: variant, block shape, blocks,
    and the table each forced shape took."""
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.ops.kernels import extension

    ext = extension()
    rows_n = xd.shape[0] if xd.dim() == 2 else 1
    n_win = tonepower.n_windows(xd.shape[-1], window, stride)
    variant, warps, wpw, blocks, smem, optin = ext.tone_plan(False, rows_n, n_win, window,
                                                             stride)
    _tone_launched(name, window, stride, False, warps, wpw, variant == "streamed")
    by_shape = {}
    for shape in ext.tone_powers_shapes():
        r400, r7500, streamed = ext.tone_ratios(xd, tm, window, stride, n_win, *shape)
        assert (torch.equal(_nan7(r400), _nan7(got[0]))
                and torch.equal(_nan7(r7500), _nan7(got[1]))), (name, shape)
        by_shape[f"{shape[0]}x{shape[1]}"] = "streamed" if streamed else "resident"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    standard = tuple(ext.tone_powers_shapes()[0])
    assert (warps, wpw) == standard or blocks <= sms, (name, warps, wpw, blocks, sms)
    return dict(variant=variant, block_shape=[warps, wpw], blocks=blocks, smem_bytes=smem,
                optin_bytes=optin, variant_by_shape=by_shape, standard_shape=list(standard))


# phase 2's cases whose block shape is asserted: a grid under one wave on
# one drop of 60 s (13 blocks of the standard shape), and the standard shape
# where it fills the card (600 s: 122 blocks and no small shape that fits
# one wave; 8 and 64 rows of 60 s)
SMALL_GRID_CASES = ("zero tail 60 s", "120 s drop", "300 s drop")
STANDARD_GRID_CASES = ("600 s 44.1 kHz", "batch 8 x 60 s (conditioned archive rows)",
                       "batch 64 x 60 s (conditioned archive rows)")


def phase2_kernel(drops: dict) -> dict:
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.ops.kernels import extension

    ext = extension()
    worst, shapes = 0.0, []
    for name, xd, fs in _kernel_cases(drops):
        window, stride, tm = _table(fs)
        n_win = tonepower.n_windows(xd.shape[-1], window, stride)
        got = tonepower.tone_ratios(xd, tm, window, stride)
        plan = _ratios_at_every_shape(name, xd, tm, window, stride, got)
        ref = tonepower.tone_ratios_reference(xd, tm, window, stride)
        assert got[0].shape == xd.shape[:-1] + (n_win,), name
        err = _max_err(got, ref, name)
        worst = max(worst, err)
        assert plan["variant"] == "resident", (name, plan)  # every rate up to 50 kHz
        small = plan["block_shape"] != plan["standard_shape"]
        assert small or name not in SMALL_GRID_CASES, (name, plan)
        assert not small or name not in STANDARD_GRID_CASES, (name, plan)
        if xd.dim() == 2:
            _rows_bitwise(xd, got, lambda row: tonepower.tone_ratios(row, tm, window, stride),
                          name)
        turns = {"kernel": lambda: tonepower.tone_ratios(xd, tm, window, stride),
                 "plain": lambda: tonepower.tone_ratios_reference(xd, tm, window, stride)}
        if small:  # the standard shape in the same turns
            turns["standard"] = lambda: ext.tone_ratios(xd, tm, window, stride, n_win,
                                                        *plan["standard_shape"])
        ms = _time_turns(turns, runs=20, calls=10)
        km, pm = ms["kernel"], ms["plain"]
        rows_n = xd.shape[0] if xd.dim() == 2 else 1
        bound_ms, bound_by = _bound(rows_n, xd.shape[-1], window, n_win)
        core_ms = _dft_core_ms(xd, tm, window, stride)
        rec = dict(shape=name, rows=rows_n, n=int(xd.shape[-1]), stride=stride, n_win=n_win,
                   max_abs_err=err, ms=km, device_ms=None, plain_ms=pm,
                   bound_us=1e3 * bound_ms, bound_by=bound_by, share_of_bound=bound_ms / km,
                   dft_core_matmul_ms=core_ms, standard_ms=ms.get("standard"),
                   standard_device_ms=None, **plan)
        shapes.append(rec)
        log(f"[2] {name}: rows {rows_n} n={rec['n']} stride {stride} n_win={n_win} NaN windows="
            f"{int(torch.isnan(got[0]).sum())} max_abs_err={err:.3g} (rtol=atol={RTOL})"
            + (", every row bitwise equal to the 1-D kernel" if xd.dim() == 2 else "")
            + f"; block shape {tuple(plan['block_shape'])} ({plan['blocks']} blocks, the "
            f"launcher's record names it), bit-equal at every shape {plan['variant_by_shape']}"
            + f"; kernel {km:.4f} ms"
            + (f" (the standard shape {ms['standard']:.4f} ms)" if small else "")
            + f", plain {pm:.4f} ms, bound {rec['bound_us']:.1f} us ({bound_by}), share of "
            f"bound {rec['share_of_bound']:.3f}; for reference only, one torch.matmul of the "
            f"tile view by the (stride, 18) segment matrix (the DFT core alone, not the same "
            f"function): {core_ms:.4f} ms")
    return dict(max_abs_err=worst, shapes=shapes, streamed=_phase2_streamed())


def _phase2_streamed() -> list:
    """Phase 2's high-rate cases: the launcher's plan streams the table;
    ``tone_ratios`` and ``tone_powers`` within rtol = atol = 2e-4 of their
    plain versions, each batch row bitwise its 1-D call, ``tone_powers``
    bit-equal at every block shape (at 88.2 kHz the (8, 2) shape holds its
    table resident: the two variants give the same bits); times, the bound
    and the DFT core's product."""
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.ops.kernels import extension

    ext = extension()
    block_shapes = ext.tone_powers_shapes()
    out = []
    for name, xd, fs in _high_rate_cases():
        window, stride, tm = _table(fs)
        rows_n = xd.shape[0] if xd.dim() == 2 else 1
        n_win = tonepower.n_windows(xd.shape[-1], window, stride)
        before = tonepower.tone_ratios.streamed_launches
        got = tonepower.tone_ratios(xd, tm, window, stride)
        assert tonepower.tone_ratios.streamed_launches == before + 1, name
        plan = _ratios_at_every_shape(name, xd, tm, window, stride, got)
        assert plan["variant"] == "streamed" and plan["smem_bytes"] <= plan["optin_bytes"], \
            (name, plan)
        small = plan["block_shape"] != plan["standard_shape"]
        assert small == (rows_n == 1), (name, plan)  # one row: 13 blocks of the standard shape
        err = _max_err(got, tonepower.tone_ratios_reference(xd, tm, window, stride), name)
        powers = tonepower.tone_powers(xd, tm, window, stride)
        perr = _max_err([powers], [tonepower.tone_powers_reference(xd, tm, window, stride)],
                        f"{name}, tone_powers")
        by_shape = {}
        for shape in block_shapes:
            before = tonepower.tone_powers.streamed_launches
            assert torch.equal(tonepower.tone_powers(xd, tm, window, stride, shape), powers), \
                (name, shape)
            by_shape[f"{shape[0]}x{shape[1]}"] = (
                "streamed" if tonepower.tone_powers.streamed_launches > before else "resident")
        if xd.dim() == 2:
            _rows_bitwise(xd, got, lambda row: tonepower.tone_ratios(row, tm, window, stride),
                          name)
            for r in range(rows_n):
                assert torch.equal(tonepower.tone_powers(xd[r], tm, window, stride),
                                   powers[r]), (name, r)
        turns = {"kernel": lambda: tonepower.tone_ratios(xd, tm, window, stride),
                 "plain": lambda: tonepower.tone_ratios_reference(xd, tm, window, stride)}
        if small:  # the standard shape in the same turns
            turns["standard"] = lambda: ext.tone_ratios(xd, tm, window, stride, n_win,
                                                        *plan["standard_shape"])
        ms = _time_turns(turns, runs=20, calls=10)
        km, pm = ms["kernel"], ms["plain"]
        bound_ms, bound_by = _bound(rows_n, xd.shape[-1], window, n_win)
        core_ms = _dft_core_ms(xd, tm, window, stride)
        rec = dict(shape=name, fs=fs, rows=rows_n, n=int(xd.shape[-1]), window=window,
                   stride=stride, n_win=n_win, max_abs_err=err,
                   powers_max_abs_err=perr, powers_variant_by_shape=by_shape, ms=km,
                   device_ms=None, plain_ms=pm, bound_us=1e3 * bound_ms, bound_by=bound_by,
                   share_of_bound=bound_ms / km, dft_core_matmul_ms=core_ms,
                   standard_ms=ms.get("standard"), standard_device_ms=None, **plan)
        out.append(rec)
        log(f"[2] {name}: window {window}, stride {stride}, n_win {n_win}: the "
            f"{plan['variant']} table ({plan['smem_bytes']} B of shared memory of "
            f"{plan['optin_bytes']}; {plan['blocks']} blocks of {tuple(plan['block_shape'])}, "
            f"the launcher's record names it; tone_ratios bit-equal at every block shape "
            f"{plan['variant_by_shape']}); "
            f"tone_ratios max_abs_err={err:.3g}, tone_powers {perr:.3g} (rtol=atol={RTOL})"
            + (", every row bitwise equal to the 1-D kernel" if xd.dim() == 2 else "")
            + f"; tone_powers bit-equal at every block shape ({by_shape}); kernel {km:.4f} ms"
            + (f" (the standard shape {ms['standard']:.4f} ms)" if small else "")
            + f", plain {pm:.4f} ms, bound {rec['bound_us']:.1f} us ({bound_by}), share of "
            f"bound {rec['share_of_bound']:.3f}; for reference only, the DFT core's "
            f"torch.matmul {core_ms:.4f} ms")
    return out


class _Standin:
    """Stands in for a kernel's wrapper (``fn``) under the wrapper's name in
    its module while a path runs.  Its counts (``launches``,
    ``streamed_launches``) are the wrapper's own: the wrapper counts through
    its module name, which then names the stand-in."""

    _COUNTS = ("launches", "streamed_launches")

    def __getattr__(self, attr):
        if attr in _Standin._COUNTS:
            return getattr(self.fn, attr)
        raise AttributeError(attr)

    def __setattr__(self, attr, value):
        if attr in _Standin._COUNTS:
            setattr(self.fn, attr, value)
        else:
            object.__setattr__(self, attr, value)


class _Recorder(_Standin):
    """Notes each call's arguments (and the path that made it) and calls the
    wrapper."""

    def __init__(self, fn, log: list, path: list):
        self.fn, self.log, self.path = fn, log, path

    def __call__(self, *args, **kwargs):
        self.log.append((self.path[0], args, kwargs))
        return self.fn(*args, **kwargs)


@contextlib.contextmanager
def _eager_programs():
    """While the block runs, every cached program (``models/programs.py``)
    runs its module's forward eagerly over its static buffers, as a
    program's first decode does, and neither captures nor replays: a
    stand-in for a kernel's wrapper then sees every call a decode makes (a
    replay calls no wrapper), and no stand-in runs inside a capture (where
    a recorded tensor would be the graph's and a check's host read would
    fail the capture).  Also the eager side of the walls in turns."""
    from axctdprocessor_tpu_torch.models import programs

    capture, replay = programs.Program.capture, programs.Program.replay
    programs.Program.capture = programs.Program.replay = programs.Program.run_eager
    try:
        yield
    finally:
        programs.Program.capture, programs.Program.replay = capture, replay


def _record_chain_calls(drops: dict) -> dict:
    """The chain kernels' arguments as the main paths hand them over: the
    600 s drop monolithic, segmented and time-sharded on dp 1 x sp 4, 4
    archive rows time-sharded on dp 2 x sp 2, the archive batch's first 8
    rows and all 64 through ``decode_batch``, and 2 x 8 rows through
    ``decode_batches_pipelined``.  Returns {kernel: [(path, args), ...]}."""
    from axctdprocessor_tpu_torch.models import engine
    from axctdprocessor_tpu_torch.ops import chain
    from axctdprocessor_tpu_torch.parallel import batch, pipeline, timeshard
    from axctdprocessor_tpu_torch.parallel.mesh import make_mesh
    from axctdprocessor_tpu_torch.utils.wavio import read_wav_raw16

    raw, fs = read_wav_raw16(drops["wav"])
    rows, bfs = drops["batch"], drops["batch_fs"]
    card = torch.device("cuda", 0)
    runs = [
        ("600 s", lambda: engine.decode_waveform(raw, fs, device="cuda", mode="monolithic")),
        ("600 s segmented", lambda: engine.decode_waveform(raw, fs, device="cuda",
                                                           mode="segmented")),
        ("600 s time-sharded, dp 1 x sp 4", lambda: timeshard.decode_batch_timesharded(
            raw[None], fs, mesh=make_mesh({"dp": 1, "sp": 4}, [card] * 4))),
        ("4 x 60 s time-sharded, dp 2 x sp 2", lambda: timeshard.decode_batch_timesharded(
            rows[:4], bfs, mesh=make_mesh({"dp": 2, "sp": 2}, [card] * 4))),
        ("batch 8 x 60 s", lambda: batch.decode_batch(rows[:8], bfs, device="cuda")),
        ("batch 64 x 60 s", lambda: batch.decode_batch(rows, bfs, device="cuda")),
        ("pipeline 2 x 8 x 60 s", lambda: pipeline.decode_batches_pipelined(
            [(sub, None) for sub in np.split(rows[:16], 2)], bfs, device="cuda")),
    ]
    calls = {name: [] for name in CHAIN_REPLACES}
    path = [""]
    originals = {name: getattr(chain, CHAIN_WRAPPERS[name]) for name in CHAIN_REPLACES}
    for name, fn in originals.items():
        setattr(chain, CHAIN_WRAPPERS[name], _Recorder(fn, calls[name], path))
    try:
        with _eager_programs():
            for label, run in runs:
                path[0] = label
                run()
    finally:
        for name, fn in originals.items():
            setattr(chain, CHAIN_WRAPPERS[name], fn)
    for name, made in calls.items():
        missing = {label for label, _ in runs} - {p for p, _, _ in made}
        assert not missing, f"{name}: no call recorded on {sorted(missing)}"
    return {name: [(p, a) for p, a, _ in made] for name, made in calls.items()}


def _chain_bound(rows: int, m: int, k: int) -> float:
    """The least time in ms for the bytes a chain call must move at 3.35 TB/s
    (its integer operations, a few per entry, take far less): the (rows, m)
    int64 successor table read once and the (rows, k) int64 chain written
    once."""
    return 1e3 * rows * (m + k) * 8 / HBM_BYTES_PER_S


def _chain_edge_cases(dev) -> list:
    """(name, successor tables (B, m) int64 on the card, start, k, kind) of the
    walks' edge cases and of the two segment walks' seams; kind "strided"
    (``chain_enumerate_strided``), "frames" (``chain_enumerate_frames``) or
    "jumps" (``chain_enumerate``, a general map)."""
    from axctdprocessor_tpu_torch.ops import chain

    rng = np.random.default_rng(3)
    seg = chain.SEGMENT
    tile = seg * chain.SEGMENTS_PER_BLOCK

    def strided(rows, m, stall=0.003):
        nxt = np.arange(m) + rng.integers(1, 5, (rows, m))
        nxt = np.where(rng.random((rows, m)) < stall, np.arange(m), nxt)
        return np.minimum(nxt, m - 1)

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

    def crossing_rows(m, n_valid):
        # crossings of rows of different true lengths: BIG past n_valid (the
        # zero-padded tail); a row with n_valid 0 is dead (no crossing)
        cross = np.cumsum(rng.integers(20, 36, (len(n_valid), m)), axis=1)
        cross = np.where(np.arange(m) < np.asarray(n_valid)[:, None], cross,
                         np.iinfo(np.int32).max // 2)
        return chain.bit_edge_successors(card(cross), card(n_valid), 44100.0, 800.0)

    def accepts(rows, n, density, runs=True):
        # random accepts; with `runs`, a run of frames every 32 bits in each row
        a = rng.random((rows, n)) < density
        for r in range(rows if runs else 0):
            s0 = int(rng.integers(0, n // 2))
            a[r, s0: s0 + n // 3: 32] = True
        return a

    def frames(acc, n_bits):
        # frame sync's successor table, built on the card as the decodes build it
        _, _, succ = chain.frame_successors(torch.from_numpy(acc).to(dev), card(n_bits))
        return succ

    early = strided(3, 6000)
    early[:, 40:60] = np.arange(40, 60)  # stalls a few steps in
    m4 = 2 * tile + 5 * seg
    step4 = np.minimum(np.arange(m4) + 4, m4 - 1)  # enters every segment at its first entry
    fixed = np.stack([step4] * 3)
    fixed[0, 5 * seg] = 5 * seg                                 # a segment's first entry
    fixed[1, [8 * seg - 4, 8 * seg - 1]] = 8 * seg - 1          # a segment's last entry
    fixed[2, [tile - 4, tile - 1]] = tile - 1                   # a tile's last entry
    dead_beside = strided(3, 7000, stall=0.0)
    dead_beside[1] = np.arange(7000)
    fseg = chain.FRAME_STRIDE
    ftile = fseg * chain.FRAME_WARPS * chain.FRAME_SEGMENTS_PER_WARP
    fm = 3 * ftile + 77
    s32 = np.minimum(np.arange(fm) + fseg, fm - 1)  # enters every segment and tile at offset 0
    fixed32 = np.stack([s32] * 3)
    fixed32[0, 5 * fseg] = 5 * fseg                        # a warp's first lane
    fixed32[1, [7 * fseg, 8 * fseg - 1]] = 8 * fseg - 1    # a warp's last lane, by a step of 31
    fixed32[2, [ftile - fseg, ftile - 1]] = ftile - 1      # a tile's last entry
    nb = 40000  # bits: cap 3,524
    live = accepts(2, nb, 0.05)
    return [
        ("k = 1", card(strided(2, 500)), 0, 1, "strided"),
        ("k = 2", card(strided(2, 500)), 0, 2, "strided"),
        ("k = 100 <= first (no tail)", card(strided(3, 2000)), 0, 100, "strided"),
        ("k = 128 = first", card(strided(3, 2000)), 0, 128, "strided"),
        ("k = 1000, not a multiple of first", card(strided(3, 5000)), 0, 1000, "strided"),
        ("dead table (all fixed points)", card(np.tile(np.arange(4000), (2, 1))), 0, 3000,
         "strided"),
        ("early stalls", card(early), 0, 5000, "strided"),
        ("4 rows of true lengths 20000, 15000, 3000, 0 (tails BIG-padded)",
         crossing_rows(20000, [20000, 15000, 3000, 0]), 0, 12000, "strided"),
        ("jumps: k = 50 <= first", card(np.minimum(np.arange(3000) + rng.integers(0, 9, (3, 3000)),
                                                   2999)), 0, 50, "jumps"),
        ("jumps: k = 1000, a dead row", card(np.stack([
            np.minimum(np.arange(3000) + rng.integers(0, 9, 3000), 2999), np.arange(3000)])),
         0, 1000, "jumps"),
        ("seam: stride 4 onto every segment boundary", card(step4[None]), 0, m4, "strided"),
        ("seam: fixed points on a segment's first and last entry and a tile's last",
         card(fixed), 0, m4, "strided"),
        ("seam: start inside a segment, stride 4", card(step4[None]), seg + 3, m4, "strided"),
        ("seam: m < one segment", card(strided(2, seg // 2)), 0, 40, "strided"),
        ("seam: m no multiple of a segment", card(strided(2, 3 * tile + 77, stall=0.0)), 0, 10000,
         "strided"),
        ("seam: k longer than the chain", card(strided(2, 6000, stall=0.01)), 0, 6000, "strided"),
        ("seam: a dead row beside live ones", card(dead_beside), 0, 5000, "strided"),
        ("seam: 64 rows of true lengths 0 to 20000",
         crossing_rows(20000, np.linspace(0, 20000, 64).astype(np.int64)), 0, 12000, "strided"),
        ("frame seam: stride 32 onto every segment and tile boundary", card(s32[None]), 0, fm,
         "frames"),
        ("frame seam: fixed points on a warp's first and last lane and a tile's last entry",
         card(fixed32), 0, fm, "frames"),
        ("frame seam: start inside a segment, stride 32", card(s32[None]), fseg + 5, 400, "frames"),
        ("frame seam: cap < 32", frames(accepts(2, 20, 0.3, runs=False), [20, 15]), 0, 12,
         "frames"),
        ("frame seam: cap no multiple of a segment", card(np.minimum(
            np.arange(fm) + rng.integers(1, fseg + 1, (2, fm)), fm - 1)), 0, 2000, "frames"),
        ("frame seam: a dead row (no accept) beside live rows", frames(
            np.stack([live[0], np.zeros(nb, bool), live[1]]), [nb] * 3), 0, nb // 32 + 2, "frames"),
        ("frame seam: accepts overflowing cap", frames(accepts(2, nb, 0.9, runs=False),
                                                       [nb, nb - 1000]), 0, 2000, "frames"),
        ("frame seam: k = 1", frames(live, [nb, nb]), 0, 1, "frames"),
        ("frame seam: k longer than the chain", frames(accepts(2, nb, 0.01), [nb, 30000]), 0, 3000,
         "frames"),
        ("frame seam: 64 rows of different kept accepts", frames(
            accepts(64, nb, 0.05), np.linspace(0, nb, 64).astype(np.int64)), 0, 1300, "frames"),
    ]


def _time_turns(fns: dict, runs: int = 5, calls: int = 2) -> dict:
    """Median CUDA-event ms per call of each function over `runs` runs of
    `calls` back-to-back calls, the functions in turns, after a warm-up."""
    for fn in fns.values():
        fn()
        fn()
    ms = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            ms[name].append(_event_ms(fn, calls))
    return {name: statistics.median(v) for name, v in ms.items()}


def _device_total_ms(fn, calls: int = 10):
    """Device time per call of everything `fn` runs on the card (kernels,
    fills, copies), from a profile that recorded every device event
    (``_complete_device_events``; None if none did)."""
    events = _complete_device_events(fn, calls)
    return sum(e.time_range.elapsed_us() for e in events) / calls / 1e3 if events else None


def _empty_kernel() -> None:
    """One launch of a kernel that does nothing (``torch.cuda._sleep(0)``):
    the launch floor."""
    torch.cuda._sleep(0)


def _chain_timed(calls: dict):
    """(kernel, shape, facts, {version: call}) of every distinct call of the
    600 s monolithic decode and the batches of 8 and 64 rows: the kernel's
    wrapper and its plain version; for the frame walk also the jump-table walk
    it replaced (jump tables + ``chain_walk``: ``chain_enumerate``) and its jump tables
    alone (``jump_levels``)."""
    from axctdprocessor_tpu_torch.ops import chain

    versions = {"chain_walk_segments": (chain.chain_enumerate_strided,
                                        chain.chain_enumerate_strided_reference),
                "chain_walk_frames": (chain.chain_enumerate_frames, chain.chain_enumerate_reference)}
    for path in ("600 s", "batch 8 x 60 s", "batch 64 x 60 s"):
        for name, (kernel, plain) in versions.items():
            seen = set()
            for p, a in calls[name]:
                if p != path:
                    continue
                nxt, start, k = a[:3]
                m = nxt.shape[-1]
                rows = nxt.numel() // m
                if (rows, m, k) in seen:
                    continue
                seen.add((rows, m, k))
                what = "int64 successors" if name == "chain_walk_segments" else "frame successors"
                fns = {"kernel": lambda a=a, f=kernel: f(*a), "plain": lambda a=a, f=plain: f(*a)}
                if name == "chain_walk_frames":
                    fns["jump_walk"] = lambda a=a: chain.chain_enumerate(*a)
                    fns["jump_tables"] = lambda a=a: chain.jump_levels(a[0], a[2])
                yield (name, f"{path}: ({rows}, {m}) {what}, k = {k}",
                       dict(rows=rows, m=m, k=k, bound_ms=_chain_bound(rows, m, k)), fns)


def _chain_walk_args(calls: dict):
    """(shape, jump tables, start, k, first) for ``chain_walk`` alone: the
    jump tables of the 600 s monolithic decode's largest frame-sync table."""
    from axctdprocessor_tpu_torch.ops import chain

    nxt, start, k = max((a[:3] for p, a in calls["chain_walk_frames"] if p == "600 s"),
                        key=lambda a: a[0].shape[-1])
    levels, first = chain.jump_levels(nxt, k)
    return (f"600 s: ({levels.shape[0]}, {levels.shape[1]}, {levels.shape[2]}) int64 jump "
            f"tables, k = {k}", levels, start, k, first)


def phase2b_chain(drops: dict) -> dict:
    """The chain kernels against their plain versions on the card, bit for
    bit, at the shapes the main paths give them (recorded from the decodes
    themselves, ``_record_chain_calls``: the 600 s drop's successor tables
    from its crossings, monolithic, segmented and time-sharded, the archive
    rows time-sharded, as batches of 8 and 64 and pipelined, and the
    frame-sync tables of the same decodes), then at the edge cases and seams.
    Times per call (CUDA events, warm, kernel and plain in turns), the bound
    and the share of it; for the frame walk also the jump-table walk's whole
    call and the launch floor."""
    from axctdprocessor_tpu_torch.ops import chain

    calls = _record_chain_calls(drops)
    kernel = {name: getattr(chain, wrapper) for name, wrapper in CHAIN_WRAPPERS.items()}
    plain = {"chain_walk_segments": chain.chain_enumerate_strided_reference,
             "chain_walk_frames": chain.chain_enumerate_reference}
    out = {name: [] for name in kernel}
    n_rows = {name: 0 for name in kernel}
    for name, recorded in calls.items():
        assert recorded, f"the main paths made no {name} call"
        for path, args in recorded:  # every recorded call, bit for bit
            got, want = kernel[name](*args), plain[name](*args)
            assert got.dtype == want.dtype and torch.equal(got, want), f"{name} differs: {path}"
            if name == "chain_walk_frames":  # and jump tables + chain_walk
                assert torch.equal(chain.chain_enumerate(*args), got), f"{name} vs chain_walk: {path}"
            if got.dim() == 2:
                for r in range(got.shape[0]):  # each row alone, as a 1-D call
                    assert torch.equal(kernel[name](args[0][r], *args[1:]), got[r]), (name, path, r)
                n_rows[name] += got.shape[0]
    floor = _time_turns({"empty": _empty_kernel}, runs=5, calls=10)["empty"]
    for name, shape, meta, fns in _chain_timed(calls):
        timed = fns if name == "chain_walk_frames" else {
            v: fns[v] for v in ("kernel", "plain")}
        ms = _time_turns({v: fn for v, fn in timed.items() if v != "jump_tables"})
        rec = dict(shape=shape, ms=ms["kernel"], plain_ms=ms["plain"],
                   share_of_bound=meta["bound_ms"] / ms["kernel"], device_ms=None, **meta)
        if name == "chain_walk_frames":
            rec.update(jump_walk_ms=ms["jump_walk"], launch_floor_ms=floor,
                       share_of_floor=floor / ms["kernel"])
        out[name].append(rec)
    for name, recs in out.items():
        for r in recs:
            log(f"[2b] {name} {r['shape']}: bit for bit equal to the plain version; kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {1e3 * r['bound_ms']:.3f} "
                f"us (bytes), share of bound {r['share_of_bound']:.4f}"
                + (f"; jump tables + chain_walk {r['jump_walk_ms']:.4f} ms; an empty kernel "
                   f"{r['launch_floor_ms']:.4f} ms, share of that floor {r['share_of_floor']:.3f}"
                   if "jump_walk_ms" in r else ""))
    shape, levels, start, k, first = _chain_walk_args(calls)
    walk = {"kernel": lambda: chain.chain_walk(levels, start, k, first),
            "plain": lambda: chain.chain_walk_reference(levels, start, k, first)}
    assert torch.equal(walk["kernel"](), walk["plain"]()), "chain_walk"
    ms = _time_turns(walk)
    bound_ms = 1e3 * 8 * (levels.numel() + levels.shape[1] * k) / HBM_BYTES_PER_S
    out["chain_walk"] = [dict(shape=shape, ms=ms["kernel"], plain_ms=ms["plain"],
                              bound_ms=bound_ms, device_ms=None)]
    log(f"[2b] chain_walk alone (the general map's walk, on no decode path) {shape}: bit for bit "
        f"equal to the plain version; kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, "
        f"bound {1e3 * bound_ms:.3f} us (bytes)")
    n_calls = {name: len(c) for name, c in calls.items()}
    paths = sorted({p for c in calls.values() for p, _ in c})
    log(f"[2b] every recorded call of the main paths ({'; '.join(paths)}) bit for bit equal "
        f"to its plain version: {n_calls}, each frame walk also to jump tables + chain_walk; "
        f"rows of the batched calls each equal to its 1-D call: {n_rows}")
    dev = torch.device("cuda")
    wrapper = {"strided": (chain.chain_enumerate_strided, chain.chain_enumerate_strided_reference),
               "frames": (chain.chain_enumerate_frames, chain.chain_enumerate_reference),
               "jumps": (chain.chain_enumerate, chain.chain_enumerate_reference)}
    for case, nxt, start, k, kind in _chain_edge_cases(dev):
        run, ref = wrapper[kind]
        before = run.launches if kind != "jumps" else chain.chain_walk.launches
        got = run(nxt, start, k)
        launched = (run.launches if kind != "jumps" else chain.chain_walk.launches) - before
        assert launched == {"strided": 3, "frames": 1, "jumps": 1}[kind], (case, launched)
        want = ref(nxt, start, k)
        assert got.shape == (nxt.shape[0], k) and torch.equal(got, want), case
        if kind == "frames":
            assert torch.equal(chain.chain_enumerate(nxt, start, k), got), case
        for r in range(nxt.shape[0]):  # each row alone, as a 1-D call
            assert torch.equal(run(nxt[r], start, k), got[r]), (case, r)
        log(f"[2b] edge case ({kind}) {case}: {tuple(nxt.shape)}, start {start} -> "
            f"{tuple(got.shape)} bit for bit equal to the plain version"
            + (" and to jump tables + chain_walk" if kind == "frames" else "")
            + ", every row equal to its 1-D call")
    return out


def _filter_rows(x, response, nfft: int, width):
    """The FFT filter over the rows of `x` (B, n), `width` rows per FFT call
    (None: all rows in one call; the last chunk padded with zero rows)."""
    def one(rows):
        return torch.fft.irfft(torch.fft.rfft(rows, nfft) * response, nfft)

    if width is None:
        return one(x)
    b = x.shape[0]
    pad = -b % width
    xp = torch.cat([x, x.new_zeros((pad, x.shape[1]))]) if pad else x
    return torch.cat([one(xp[i: i + width]) for i in range(0, b + pad, width)])[:b]


def _fft_cases(drops: dict) -> list:
    """(name, rows on the card, the demod filter's response, nfft, batch
    sizes): the 600 s drop conditioned on the card and cut into the
    segmented path's haloed extensions (nfft 2^20), and the archive rows
    conditioned on the card (the 60 s row's nfft)."""
    from axctdprocessor_tpu_torch.models import engine, segmented
    from axctdprocessor_tpu_torch.ops import iir
    from axctdprocessor_tpu_torch.utils.config import DecoderConfig
    from axctdprocessor_tpu_torch.utils.wavio import read_wav_raw16

    dev = torch.device("cuda")
    cfg = DecoderConfig()
    raw, fs = read_wav_raw16(drops["wav"])
    n = len(raw)
    x = engine.condition_integer(torch.from_numpy(raw).to(dev), n, torch.full((), n, device=dev))
    _, _, seg_len, right, _ = segmented._seg_geometry(float(fs))
    ext_len = segmented.LEFT_HALO + seg_len + right
    n_seg = -(-n // seg_len)
    xp = torch.nn.functional.pad(x, (segmented.LEFT_HALO, n_seg * seg_len + right - n))
    segs = xp.unfold(0, ext_len, seg_len)[:n_seg].contiguous()
    rows = drops["batch"]
    nb = rows.shape[1]
    cond = engine.condition_integer(torch.from_numpy(rows).to(dev), nb,
                                    torch.full((rows.shape[0],), nb, device=dev))

    def response(fs_, n_, nfft):
        dims = engine.EngineDims.for_waveform(n_, fs_, cfg.bitrate, engine.probe_window(cfg, fs_))
        sos = torch.from_numpy(engine.engine_tables(cfg, fs_, dims)["sos"]).to(dev)
        return engine.sos_response_on_device(sos, nfft)

    nfft60 = iir.next_pow2(nb + 4096)
    return [(f"600 s segments ({n_seg} x {ext_len}), nfft 2^20", segs,
             response(float(fs), seg_len, segmented.SEG_NFFT), segmented.SEG_NFFT,
             (1, 2, 4, 8, n_seg)),
            (f"60 s archive rows ({nb}), nfft {nfft60}", cond,
             response(float(drops["batch_fs"]), nb, nfft60), nfft60, (8, 64))]


def phase2c_fft(drops: dict) -> list:
    """Whether cuFFT filters a row of a batch bit for bit as the row alone:
    at each batch size B, the demod filter (``rfft``, times the response,
    ``irfft``) over (B, nfft) in one call against each row in a call of its
    own, and the ``rfft`` alone; then in chunks of a fixed width W against the
    row alone in a chunk of W padded with zero rows; the time of one call
    against row by row.  Last, the rule the port runs
    (``engine.FFT_ROWS_PER_CALL["cuda"]`` rows a call) is held to it: every row of
    ``engine.apply_response`` over the batch equal to the 1-D call."""
    from axctdprocessor_tpu_torch.models import engine

    found = []
    policy_rows = []
    for name, allx, resp, nfft, sizes in _fft_cases(drops):
        for b in (b for b in sizes if b <= allx.shape[0]):
            xb = allx[:b]
            whole = _filter_rows(xb, resp, nfft, None)
            spec = torch.fft.rfft(xb, nfft)
            alone = [_filter_rows(xb[r: r + 1], resp, nfft, None)[0] for r in range(b)]
            eq = sum(torch.equal(whole[r], alone[r]) for r in range(b))
            eq_rfft = sum(torch.equal(spec[r], torch.fft.rfft(xb[r], nfft)) for r in range(b))
            eq_1d = torch.equal(_filter_rows(xb[:1], resp, nfft, None)[0],
                                torch.fft.irfft(torch.fft.rfft(xb[0], nfft) * resp, nfft))
            diff = max(float((whole[r] - alone[r]).abs().max()) for r in range(b))
            chunks = {}
            for w in (2, 4, 8) if b > 1 else ():
                got = _filter_rows(xb, resp, nfft, w)
                chunks[w] = sum(torch.equal(got[r], _filter_rows(xb[r: r + 1], resp, nfft, w)[0])
                                for r in range(b))
            del whole, spec, alone
            ms = _time_turns({"one call": lambda: _filter_rows(xb, resp, nfft, None),
                              "row by row": lambda: _filter_rows(xb, resp, nfft, 1)},
                             runs=3, calls=1)
            rec = dict(case=name, rows=b, nfft=nfft, rows_equal=eq, rfft_rows_equal=eq_rfft,
                       row_2d_equal_1d=eq_1d, max_abs_diff=diff, chunked_rows_equal=chunks,
                       one_call_ms=ms["one call"], row_by_row_ms=ms["row by row"])
            found.append(rec)
            log(f"[2c] FFT filter, {name}, B = {b}: rows of one (B, nfft) call bit-equal to the "
                f"row alone {eq}/{b} (rfft alone {eq_rfft}/{b}, largest difference {diff:.3g}); "
                f"a (1, nfft) call equal to the 1-D call: {eq_1d}; in fixed chunks of W rows "
                f"(padded) equal to the row alone in a chunk of W: "
                + (", ".join(f"W = {w}: {c}/{b}" for w, c in chunks.items()) or "not run")
                + f"; one call {ms['one call']:.3f} ms, row by row {ms['row by row']:.3f} ms")
            got = engine.apply_response(xb, resp, nfft)
            policy_rows.append((name, b, sum(torch.equal(got[r], engine.apply_response(
                xb[r], resp, nfft)) for r in range(b))))
            del got
    log(f"[2c] the port's rule, engine.FFT_ROWS_PER_CALL['cuda'] = "
        f"{engine.FFT_ROWS_PER_CALL['cuda']}: rows of "
        f"engine.apply_response over a batch equal to the 1-D call: "
        + "; ".join(f"{name} B = {b}: {e}/{b}" for name, b, e in policy_rows))
    assert all(e == b for _, b, e in policy_rows), policy_rows
    return found


def _record_frontend_calls(drops: dict) -> dict:
    """The front-end kernels' arguments as the main paths hand them over: the
    600 s drop monolithic, segmented (groups of 4), prestaged (``fused``: every
    segment in one pass), time-sharded on dp 1 x sp 4 and streamed (1 s float
    blocks, one segment a call), and the archive batch's first 8 rows and all
    64 through ``decode_batch``.  Returns {kernel: [(path, args), ...]}."""
    from axctdprocessor_tpu_torch.models import engine, segmented
    from axctdprocessor_tpu_torch.models.stream_device import DeviceStreamDecoder
    from axctdprocessor_tpu_torch.ops import goertzel, tonepower
    from axctdprocessor_tpu_torch.parallel import batch, timeshard
    from axctdprocessor_tpu_torch.parallel.mesh import make_mesh
    from axctdprocessor_tpu_torch.utils.wavio import read_wav, read_wav_raw16

    raw, fs = read_wav_raw16(drops["wav"])
    rows, bfs = drops["batch"], drops["batch_fs"]
    card = torch.device("cuda", 0)
    staged = segmented.prestage_waveform(raw, fs, device="cuda", fused=True)
    pcm, _ = read_wav(drops["wav"])

    def stream():
        dec = DeviceStreamDecoder(fs, device="cuda")
        for i in range(0, len(pcm), int(fs)):
            dec.feed(pcm[i: i + int(fs)])
        dec.finalize()
    runs = [
        ("600 s", lambda: engine.decode_waveform(raw, fs, device="cuda", mode="monolithic")),
        ("600 s segmented", lambda: engine.decode_waveform(raw, fs, device="cuda",
                                                           mode="segmented")),
        ("600 s prestaged, fused", staged.decode),
        ("600 s time-sharded, dp 1 x sp 4", lambda: timeshard.decode_batch_timesharded(
            raw[None], fs, mesh=make_mesh({"dp": 1, "sp": 4}, [card] * 4))),
        ("600 s stream, 1 s float blocks", stream),
        ("batch 8 x 60 s", lambda: batch.decode_batch(rows[:8], bfs, device="cuda")),
        ("batch 64 x 60 s", lambda: batch.decode_batch(rows, bfs, device="cuda")),
    ]
    where = {"probe_at": goertzel, "tone_powers": tonepower}
    calls = {name: [] for name in where}
    path = [""]
    originals = {name: getattr(mod, name) for name, mod in where.items()}
    for name, mod in where.items():
        setattr(mod, name, _Recorder(originals[name], calls[name], path))
    try:
        with _eager_programs():
            for label, run in runs:
                path[0] = label
                run()
    finally:
        for name, mod in where.items():
            setattr(mod, name, originals[name])
    assert {p for p, _, _ in calls["probe_at"]} == {label for label, _ in runs}, "probe_at"
    assert calls["tone_powers"], "no tone_powers call recorded"
    return {name: [(p, a) for p, a, _ in made] for name, made in calls.items()}


def _probe_bound(x, starts, window: int) -> tuple[float, str]:
    """The least time for ``probe_at``'s work: the samples its frames cover
    read once (counted from this call's starts), the starts, the table and
    the (.., K, 2) output; against 8 flop a frame sample."""
    rows = x.reshape(-1, x.shape[-1])
    st = starts.reshape(rows.shape[0], -1).clamp(0, x.shape[-1] - window)
    k_all = st.numel()
    if k_all:
        srt = torch.sort(st, dim=-1).values
        covered = int(torch.clamp(srt.diff(dim=-1), max=window).sum()) + window * st.shape[0]
    else:
        covered = 0
    nbytes = 4 * covered + 8 * k_all + 16 * window + 8 * k_all
    flop = 8 * window * k_all
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _powers_bound(rows: int, n: int, window: int, n_win: int) -> tuple[float, str]:
    """The least time for ``tone_powers``' work: the samples and the table
    read once, the (rows, n_win, 3) powers written once, against six
    length-`window` dot products and three magnitudes a window."""
    nbytes = 4 * (rows * n + window * 6 + 3 * rows * n_win)
    flop = rows * n_win * (12 * window + 9)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _frontend_fns():
    from axctdprocessor_tpu_torch.ops import goertzel, tonepower

    return {"probe_at": (goertzel.probe_at, goertzel.tone_power_at),
            "tone_powers": (tonepower.tone_powers, tonepower.tone_powers_reference)}


def _frontend_timed(calls: dict):
    """(kernel, path, shape, args) of the first call of each path: the shapes
    the kernels are timed at."""
    for name, recorded in calls.items():
        seen = set()
        for path, args in recorded:
            if path in seen:
                continue
            seen.add(path)
            x = args[0]
            rows = x.shape[0] if x.dim() == 2 else 1
            shape = (f"{path}: x ({rows}, {x.shape[-1]}), K = {args[1].shape[-1]}, window "
                     f"{args[2]}" if name == "probe_at" else
                     f"{path}: x ({rows}, {x.shape[-1]}), window {args[2]}, stride {args[3]}")
            yield name, path, shape, args


def _frontend_library(name: str, args):
    """The one PyTorch call timed beside a front-end kernel: for the probe the
    product ``frames @ trig`` of the gathered frames alone (not the same
    function: no gather, no magnitudes); for the powers one ``torch.matmul``
    of the tile view by the (stride, 18) segment matrix (the DFT core alone)."""
    if name == "probe_at":
        x, starts, window, trig = args
        rows = x.reshape(-1, x.shape[-1])
        st = starts.reshape(rows.shape[0], -1).clamp(0, x.shape[-1] - window)
        frames = rows[torch.arange(rows.shape[0], device=x.device)[:, None, None],
                      st[..., None] + torch.arange(window, device=x.device)].reshape(-1, window)
        return lambda: torch.matmul(frames, trig)
    x, tm, window, stride = args
    n_tiles = x.shape[-1] // stride
    tiles = x[..., : n_tiles * stride].reshape(-1, stride)
    segs = torch.zeros((3, stride, 6), device=x.device)
    for j in range(3):
        seg = tm[j * stride: min((j + 1) * stride, window)]
        segs[j, : seg.shape[0]] = seg
    seg_mat = segs.permute(1, 0, 2).reshape(stride, 18).contiguous()
    return lambda: torch.matmul(tiles, seg_mat)


def _probe_edge_cases(dev) -> list:
    """``probe_at``'s runs at their edges, on 3 rows that are views of a
    wider tensor at an odd pitch (rows not 16-byte aligned): bit edges 55
    samples apart with jitter, K = 1,000 (no multiple of the run) ending in a
    long tail of the terminal edge; the same starts unsorted; starts 97
    apart (every run's span overflows the buffer); live edges then one
    start beyond L, clamped to L - window (that run overflows); K = 50 < the
    run on each row.  Each against its plain version (rtol = atol = 2e-4),
    every row bit-equal to its 1-D call, every probe bit-equal to its frame
    probed in a staged run of its own.  Returns the names of the cases."""
    from axctdprocessor_tpu_torch.ops import goertzel
    from axctdprocessor_tpu_torch.ops.kernels import extension

    ext = extension()
    run, span = ext.probe_geometry(39)
    # the standard geometry up to 50 kHz: a run of bit edges is staged at the
    # highest rate the single-drop paths decode at (62.5 samples a bit, a
    # window of 50), and edges 55 apart are staged, 97 apart not
    assert ext.probe_geometry(50) == (run, span) == tuple(ext.probe_geometries()[0])
    assert (run - 1) * 62.5 + 50 + 3 <= span and run * 97 > span > run * 57, (run, span)
    # above 50 kHz (the batch paths' rows at the native rate) another geometry
    # stages a run of bit edges: 110.25 samples a bit and a window of 81 at
    # 88.2 kHz, 120 and 88 at 96 kHz
    for window, bit in ((81, 110.25), (88, 120.0)):
        hr_run, hr_span = ext.probe_geometry(window)
        assert (hr_run, hr_span) != (run, span), window
        assert (hr_run - 1) * bit + window + 3 <= hr_span, (window, hr_run, hr_span)
    rng = np.random.default_rng(5)
    fs, window, length = 44100.0, 39, 200_000
    trig = torch.from_numpy(goertzel.tone_matrix(window, [1200.0, 2400.0], fs,
                                                 np.float32)).to(dev)
    wide = torch.from_numpy(rng.standard_normal((3, length + 11)).astype(np.float32)).to(dev)
    x = wide[:, 3: 3 + length]
    last = length - window

    def edges(k, gap, live):
        e = np.cumsum(rng.integers(gap - 1, gap + 2, (3, k)), axis=1) + rng.integers(0, 50, (3, 1))
        e[:, live:] = e[:, live - 1: live]  # the tail repeats the terminal edge
        return e

    sorted_ = edges(1000, 55, 700)
    beyond = edges(300, 55, 300)
    beyond[:, -1] = length + 100
    cases = [("sorted, K = 1,000 with a tail of 300 repeats", sorted_),
             ("unsorted", rng.permuted(sorted_, axis=1)),
             ("every run overflowing the span (starts 97 apart)", edges(1000, 97, 1000)),
             ("a last start beyond L, clamped to L - window", beyond),
             ("K = 50 < the run", edges(50, 55, 40))]
    assert 50 < run and 1000 % run and 300 % run, run
    for name, st in cases:
        assert st.max() < length + 200 and (name.startswith("a last") or st.max() <= last)
        starts = torch.from_numpy(st.astype(np.int64)).to(dev)
        got = goertzel.probe_at(x, starts, window, trig)
        _max_err([got], [goertzel.tone_power_at(x, starts, window, trig)], f"probe_at {name}")
        for r in range(3):
            assert torch.equal(goertzel.probe_at(x[r], starts[r], window, trig), got[r]), (name, r)
        # each frame probed again in a run of its own (every start repeated a run's
        # length: a span of one frame, staged), whichever path its run took here
        alone = goertzel.probe_at(x, starts.repeat_interleave(run, dim=-1), window, trig)
        assert torch.equal(alone[..., ::run, :], got), f"{name}: staged frames differ"
    return [name for name, _ in cases]


def _frontend_edge_cases(dev) -> None:
    """``probe_at`` at a start of 0, at L - window, clamped beyond both ends,
    on rows exactly one window long, and with no start (no launch);
    ``tone_powers`` on a view of a wider tensor (equal to its contiguous
    copy), at n % 4 = 1, and with no window (no launch).  Each against its
    plain version (rtol = atol = 2e-4), each row of a batch bit-equal to its
    1-D call."""
    from axctdprocessor_tpu_torch.ops import goertzel, tonepower
    from axctdprocessor_tpu_torch.ops.kernels import extension

    shapes = extension().tone_powers_shapes()
    rng = np.random.default_rng(4)
    fs, npcm = 44100.0, 39
    trig = torch.from_numpy(goertzel.tone_matrix(npcm, [400.0, 800.0], fs, np.float32)).to(dev)
    for length in (5000, npcm):
        x = torch.from_numpy(rng.standard_normal((3, length)).astype(np.float32)).to(dev)
        last = length - npcm
        st = torch.tensor([[0, last, last + 1, length + 100, -5, last // 2]] * 3,
                          dtype=torch.int64, device=dev)
        got = goertzel.probe_at(x, st, npcm, trig)
        _max_err([got], [goertzel.tone_power_at(x, st, npcm, trig)], f"probe_at L = {length}")
        clamped = goertzel.probe_at(x, st.clamp(0, last), npcm, trig)
        assert torch.equal(got, clamped), f"probe_at L = {length}: clamping"
        for r in range(3):
            assert torch.equal(goertzel.probe_at(x[r], st[r], npcm, trig), got[r]), (length, r)
        before = goertzel.probe_at.launches
        none = goertzel.probe_at(x, st[:, :0], npcm, trig)
        assert none.shape == (3, 0, 2) and goertzel.probe_at.launches == before, "K = 0"
    window, stride, tm = _table(fs)
    wide = torch.from_numpy(rng.standard_normal((4, 60000)).astype(np.float32)).to(dev)
    for x in (wide[:, 4096: 4096 + 50001], wide[:, 3: 3 + 44101]):
        got = tonepower.tone_powers(x, tm, window, stride)
        assert torch.equal(got, tonepower.tone_powers(x.contiguous(), tm, window, stride))
        want = tonepower.tone_powers_reference(x, tm, window, stride)
        _max_err([got], [want], "tone_powers view")
        for r in range(x.shape[0]):
            assert torch.equal(tonepower.tone_powers(x[r], tm, window, stride), got[r]), r
        for shape in shapes:
            assert torch.equal(tonepower.tone_powers(x, tm, window, stride, shape), got), shape
    before = tonepower.tone_powers.launches
    none = tonepower.tone_powers(wide[:, :window - 5], tm, window, stride)
    assert none.shape == (4, 0, 3) and tonepower.tone_powers.launches == before, "no window"
    runs = _probe_edge_cases(dev)
    log("[2d] edge cases: probe_at at starts 0 and L - window and clamped beyond both ends, on "
        "rows of one window, K = 0 launching nothing, and its runs: " + "; ".join(runs)
        + " (each probe also bit-equal to its frame in a staged run of its own); tone_powers "
        "on views of a wider tensor (rows not 16-byte aligned, n % 4 = 1) equal to their "
        "contiguous copies and at every block shape (warps, windows a warp) "
        f"{shapes}, no window "
        "launching nothing; each against its plain version, every row equal to its 1-D call")


HIGH_RATES = (88200, 96000)


def _high_rate_probe_calls() -> list:
    """(name, args) of ``probe_at``'s call in ``decode_batch`` of 8 rows of
    60 s at 88.2 and at 96 kHz at the native rate: one simulated drop at
    each rate (as ``tools/corpus_1000.py`` makes its bases: seed 5, the
    profile at 24 s, scaled to a peak of 28,000) plus uniform noise of +-300
    per row (rng seeded with the rate), int16."""
    from axctdprocessor_tpu_torch.models import simulator
    from axctdprocessor_tpu_torch.ops import goertzel
    from axctdprocessor_tpu_torch.parallel import batch

    out = []
    for fs in HIGH_RATES:
        pcm, _ = simulator.synthesize(simulator.SimSpec(duration=60.0, fs=fs, profile_start=24.0,
                                                        seed=5))
        base = np.round(pcm * (28000 / np.max(np.abs(pcm)))).astype(np.int16)
        rng = np.random.default_rng(fs)
        rows = np.stack([np.clip(base + rng.integers(-300, 300, len(base)), -32768, 32767)
                         .astype(np.int16) for _ in range(8)])
        calls, path = [], [""]
        real_probe = goertzel.probe_at
        goertzel.probe_at = _Recorder(real_probe, calls, path)
        try:
            with _eager_programs():
                batch.decode_batch(rows, fs, device="cuda")
        finally:
            goertzel.probe_at = real_probe
        assert len(calls) == 1, len(calls)
        out.append((f"decode_batch 8 x 60 s at {fs / 1e3:g} kHz", calls[0][1]))
    return out


def _probe_staged_share(x, starts, window: int, run: int, span: int) -> tuple[float, float]:
    """The share of ``probe_at``'s runs of `run` probes whose span plus 3
    floats of alignment fits `span` floats (the kernel's own test, computed
    from this call's starts), and the median span."""
    st = starts.reshape(-1, starts.shape[-1]).clamp(0, x.shape[-1] - window)
    pad = -st.shape[-1] % run
    lo = torch.nn.functional.pad(st, (0, pad), value=x.shape[-1]).reshape(st.shape[0], -1, run)
    hi = torch.nn.functional.pad(st, (0, pad), value=-1).reshape(st.shape[0], -1, run)
    spans = hi.amax(-1) - lo.amin(-1) + window
    return float((spans + 3 <= span).float().mean()), float(spans.float().median())


def _probe_high_rate() -> list:
    """``probe_at`` at 88.2 and 96 kHz, 8 rows of 60 s as ``decode_batch``
    hands them over: the launcher's geometry for the window (its record must
    name it, and it must stage at least 0.95 of the runs), within rtol = atol
    = 2e-4 of the plain version, every row bit-equal to its 1-D call, and
    every geometry forced (the standard one, the only one up to 50 kHz, among them)
    bit-equal to it; times in turns with the standard geometry forced, the
    plain version and ``frames @ trig``, and the bound."""
    from axctdprocessor_tpu_torch.ops import goertzel
    from axctdprocessor_tpu_torch.ops.kernels import extension

    ext = extension()
    geometries = [tuple(g) for g in ext.probe_geometries()]
    out = []
    for name, args in _high_rate_probe_calls():
        x, starts, window, trig = args
        run, span = ext.probe_geometry(window)
        got = goertzel.probe_at(*args)
        assert ext.probe_last_launch() == (run, span), (name, ext.probe_last_launch())
        err = _max_err([got], [goertzel.tone_power_at(*args)], f"probe_at {name}")
        for r in range(x.shape[0]):
            assert torch.equal(goertzel.probe_at(x[r], starts[r], window, trig), got[r]), (name, r)
        for g in geometries:
            assert torch.equal(ext.probe_at(x, starts, trig, *g), got), (name, g)
        staged, median_span = _probe_staged_share(x, starts, window, run, span)
        staged_std, _ = _probe_staged_share(x, starts, window, *geometries[0])
        assert staged >= 0.95, (name, staged)
        ms = _time_turns({"kernel": lambda: goertzel.probe_at(*args),
                          "standard": lambda: ext.probe_at(x, starts, trig, *geometries[0]),
                          "plain": lambda: goertzel.tone_power_at(*args),
                          "library": _frontend_library("probe_at", args)}, runs=5, calls=5)
        bound_ms, bound_by = _probe_bound(x, starts, window)
        rec = dict(shape=f"{name}: x {tuple(x.shape)}, K = {starts.shape[-1]}, window {window}",
                   geometry=[run, span], staged_share=staged, median_span=median_span,
                   standard_geometry=list(geometries[0]), standard_staged_share=staged_std,
                   max_abs_err=err, ms=ms["kernel"], standard_ms=ms["standard"],
                   plain_ms=ms["plain"], library_ms=ms["library"], bound_ms=bound_ms,
                   bound_by=bound_by, share_of_bound=bound_ms / ms["kernel"], device_ms=None,
                   standard_device_ms=None, library_device_ms=None)
        out.append(rec)
        log(f"[2d] probe_at {rec['shape']}: geometry (run {run}, span {span}), the launcher's "
            f"record names it; {staged:.3f} of the runs staged (median span {median_span:.0f}; "
            f"{staged_std:.3f} at the standard geometry {geometries[0]}); max_abs_err={err:.3g} "
            f"(rtol=atol={RTOL}); every row bit-equal to its 1-D call, every geometry "
            f"{geometries} bit-equal; kernel {ms['kernel']:.4f} ms, the standard geometry "
            f"{ms['standard']:.4f} ms, plain {ms['plain']:.4f} ms, frames @ trig "
            f"{ms['library']:.4f} ms, bound {1e3 * bound_ms:.2f} us ({bound_by}), share of "
            f"bound {rec['share_of_bound']:.3f}")
    return out


def phase2d_frontend(drops: dict) -> dict:
    """``probe_at`` and ``tone_powers`` against their plain versions on the
    card (rtol = atol = 2e-4) at every call the main paths hand them
    (recorded as the paths run), each row of a batched call bit-equal to its
    1-D call; then the edge cases.  At the first call of each path: times
    per call of kernel, plain version and the library product in turns, the
    bound and the share of it."""
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.ops.kernels import extension

    shapes = extension().tone_powers_shapes()
    calls = _record_frontend_calls(drops)
    fns = _frontend_fns()
    worst = {name: 0.0 for name in fns}
    n_rows = {name: 0 for name in fns}
    for name, recorded in calls.items():
        kernel, plain = fns[name]
        for path, args in recorded:
            got = kernel(*args)
            worst[name] = max(worst[name], _max_err([got], [plain(*args)], f"{name} {path}"))
            if args[0].dim() == 2:
                for r in range(args[0].shape[0]):
                    one = (kernel(args[0][r], args[1][r], *args[2:]) if name == "probe_at"
                           else kernel(args[0][r], *args[1:]))
                    assert torch.equal(one, got[r]), (name, path, r)
                n_rows[name] += args[0].shape[0]
            if name == "tone_powers":  # the launcher's shape and every other, bit for bit
                for shape in shapes:
                    assert torch.equal(kernel(*args, shape), got), (path, shape)
    log(f"[2d] every recorded call of the main paths within rtol = atol = {RTOL} of its plain "
        f"version: { {k: len(v) for k, v in calls.items()} } calls, largest error {worst}; rows "
        f"of the batched calls each bit-equal to its 1-D call: {n_rows}; tone_powers at every "
        f"call bit-equal at every block shape {shapes} to the launcher's")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {name: [] for name in fns}
    for name, path, shape, args in _frontend_timed(calls):
        kernel, plain = fns[name]
        turns = {"kernel": lambda: kernel(*args), "plain": lambda: plain(*args),
                 "library": _frontend_library(name, args)}
        x = args[0]
        rows = x.shape[0] if x.dim() == 2 else 1
        if name == "probe_at":
            bound_ms, bound_by = _probe_bound(x, args[1], args[2])
        else:
            n_win = tonepower.n_windows(x.shape[-1], args[2], args[3])
            bound_ms, bound_by = _powers_bound(rows, x.shape[-1], args[2], n_win)
            variant, *shape_run, blocks, _, _ = extension().tone_plan(True, rows, n_win,
                                                                      args[2], args[3])
            turns["standard"] = lambda: kernel(*args, shapes[0])
        ms = _time_turns(turns, runs=5, calls=5)
        rec = dict(shape=shape, path=path, rows=rows, ms=ms["kernel"], plain_ms=ms["plain"],
                   library_ms=ms["library"], bound_ms=bound_ms, bound_by=bound_by,
                   share_of_bound=bound_ms / ms["kernel"], device_ms=None)
        text = ""
        if name == "tone_powers":
            rec.update(block_shape=list(shape_run), blocks=blocks, variant=variant,
                       standard_ms=ms["standard"], standard_device_ms=None)
            text = (f" (block shape {tuple(shape_run)}: {blocks} blocks on {sms} SMs; the "
                    f"standard shape {shapes[0]} {ms['standard']:.4f} ms)")
        out[name].append(rec)
        log(f"[2d] {name} {shape}: kernel {rec['ms']:.4f} ms{text}, plain {rec['plain_ms']:.4f} "
            f"ms, library product {rec['library_ms']:.4f} ms, bound {1e3 * bound_ms:.2f} us "
            f"({bound_by}), share of bound {rec['share_of_bound']:.3f}")
    _frontend_edge_cases(torch.device("cuda"))
    high_rate = _probe_high_rate()
    worst["probe_at"] = max([worst["probe_at"]] + [r["max_abs_err"] for r in high_rate])
    return dict(shapes=out, max_abs_err=worst, high_rate=high_rate)


def phase2e_batched_rows(drops: dict) -> None:
    """The batched front end against its 1-D calls, bit for bit (every
    output, floats and integers): the 600 s drop's 26 segments in one pass
    (the prestaged ``fused`` forward's call) and in groups of 4 (the
    segmented decode's) against each segment alone (the stream decoder's
    call); from the raw int16 rows, the archive's 64 rows conditioned as one
    batch (``engine.conditioned``: an exact DC mean) against each row
    conditioned alone, then through ``FusedDecoder.stage1`` in one pass
    against each row as a batch of one, and row 0 as a 1-D call."""
    from axctdprocessor_tpu_torch.models import engine, segmented
    from axctdprocessor_tpu_torch.parallel import batch
    from axctdprocessor_tpu_torch.utils.wavio import read_wav_raw16

    raw, fs = read_wav_raw16(drops["wav"])
    st = segmented.prestage_waveform(raw, fs, device="cuda", fused=True)
    p, model = st.plan, st.plan.model
    rows = st.ext_all.reshape(-1, st.ext_all.shape[-1])[: p.n_seg]
    offs = model._offsets(0, p.n_seg, rows.device)
    with torch.inference_mode():
        every = model.segment(rows, offs, p.dc, p.peak, p.n_raw)
        groups = [model.segment(rows[i: i + 4], offs[i: i + 4], p.dc, p.peak, p.n_raw)
                  for i in range(0, p.n_seg, 4)]
        for i in range(p.n_seg):
            alone = model.segment(rows[i], i * model.seg_len, p.dc, p.peak, p.n_raw)
            group = groups[i // 4]
            for j, t in enumerate(alone):
                assert torch.equal(every[j][i], t), ("one pass", i, j)
                assert torch.equal(group[j][i % 4], t), ("groups of 4", i, j)
    log(f"[2e] the 600 s drop's {p.n_seg} segments ({p.wire} wire) in one pass and in groups of "
        f"4: every output of every segment bit-equal to the segment alone")
    pcms, fs_b = drops["batch"], drops["batch_fs"]
    n = pcms.shape[1]
    plan = batch.BatchPlan(pcms.dtype, n, fs_b, None, "int16", "cuda")
    dev = plan.dev
    nv = torch.full((pcms.shape[0],), n, dtype=torch.int64, device=dev)
    raw = engine.to_device(plan.encode(pcms), dev)
    x = engine.conditioned(raw, nv)
    for r in range(x.shape[0]):
        assert torch.equal(engine.conditioned(raw[r], nv[r]), x[r]), ("conditioned row", r)
    with torch.inference_mode():
        s1 = plan.model.stage1(x, nv)
        for r in range(x.shape[0]):
            one = plan.model.stage1(x[r: r + 1], nv[r: r + 1])
            for key, v in s1.items():
                assert torch.equal(one[key][0], v[r]), ("archive row", r, key)
        one_d = plan.model.stage1(x[0], nv[0])
        for key, v in s1.items():
            assert torch.equal(one_d[key], v[0]), ("archive row 0, 1-D", key)
    log(f"[2e] the archive's {x.shape[0]} int16 rows conditioned on the card as one batch, each "
        f"bit-equal to the row conditioned alone; through FusedDecoder.stage1 in one pass: every "
        f"output of every row ({', '.join(s1)}) bit-equal to the row as a batch of one; row 0 "
        f"also to the 1-D call")


def _profile_counts(fn) -> dict:
    """One call of `fn` (after a warm-up call) under ``torch.profiler``,
    behind a lead kernel (``_profiled``; left out of the counts):
    ``launch_counts``, the wall, device busy ms (the union of device
    activity) and idle share, and whether every host launch call has device
    events under its correlation id (``complete``; up to PROFILE_TRIES
    profiles are taken for one that does)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(LEAD_CYCLES)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.events()
        calls = sorted((e for e in events
                        if e.device_type == DeviceType.CPU and _launch_kind(e.name)),
                       key=lambda e: e.time_range.start)
        lead = {calls[0].id} if calls else set()
        out = launch_counts(events, skip=lead)
        host = {e.id for e in calls} - lead
        device = [e for e in events if e.device_type == DeviceType.CUDA and e.id not in lead]
        busy, end = 0.0, -1e30
        for a, b in sorted((e.time_range.start, e.time_range.end) for e in device):
            if b > end:
                busy += b - max(a, end)
                end = b
        out.update(complete=bool(host) and host <= {e.id for e in device},
                   wall_ms=wall_us / 1e3, busy_ms=busy / 1e3, idle_share=1 - busy / wall_us)
        if out["complete"]:
            break
        PROFILES["incomplete"] += 1
    return out


def _profile_programs(seg: dict, drops: dict) -> dict:
    """A warm decode of each path the programs serve (the 600 s drop
    monolithic, ``decode_batch`` of 8 x 60 s, the 600 s drop prestaged
    ``fused``; the 600 s drop segmented and prestaged group by group, a
    snapshot of a stream of it, the pipeline of 8 batches of 8), eager and
    through its program: the host's launch calls and the device's kernels,
    device busy time and idle share.  The device's kernels are the same in
    both for the first three; through the program the monolithic decode and
    the batch queue at most 10 host launch calls, the segmented decode at
    most 150 and the pipeline at most 30 a batch.  Returns the counts."""
    from axctdprocessor_tpu_torch.models import engine, segmented
    from axctdprocessor_tpu_torch.parallel import batch, pipeline
    from axctdprocessor_tpu_torch.utils.wavio import read_wav

    raw, fs = seg["raw"], seg["fs"]
    staged = segmented.prestage_waveform(raw, fs, device="cuda", fused=True)
    groups = segmented.prestage_waveform(raw, fs, device="cuda")
    stream, _ = _stream_fed(read_wav(drops["wav"])[0], fs, snapshots=False)
    batches8 = [(sub, None) for sub in np.split(drops["batch"], 8)]
    fns = {"600 s monolithic": lambda: engine.decode_waveform(raw, fs, device="cuda",
                                                               mode="monolithic"),
           "decode_batch of 8 x 60 s": lambda: batch.decode_batch(
               drops["batch"][:8], drops["batch_fs"], device="cuda"),
           "600 s prestaged fused": staged.decode,
           "600 s segmented": lambda: segmented.decode_waveform_segmented(raw, fs,
                                                                          device="cuda"),
           "600 s prestaged groups": groups.decode,
           "stream snapshot, 600 s": stream.results,
           "pipeline 8 x 8 x 60 s": lambda: pipeline.decode_batches_pipelined(
               batches8, drops["batch_fs"], device="cuda")}
    same_work = ("600 s monolithic", "decode_batch of 8 x 60 s", "600 s prestaged fused")
    bounds = {"600 s monolithic": 10, "decode_batch of 8 x 60 s": 10, "600 s segmented": 150,
              "pipeline 8 x 8 x 60 s": 30 * 8}
    out = {}
    for name, fn in fns.items():
        fn()
        fn()  # the program of this shape captured
        with _eager_programs():
            eager = _profile_counts(fn)
        prog = _profile_counts(fn)
        out[name] = dict(eager=eager, program=prog)
        for form, c in (("eager", eager), ("program", prog)):
            log(f"[10] {name}, {form}: {launches_text(c)}; device copies and fills "
                f"{c['device copies and fills']}; profiled wall {c['wall_ms']:.1f} ms, device busy "
                f"{c['busy_ms']:.2f} ms, idle share {c['idle_share']:.3f}"
                + ("" if c["complete"] else "; some device events not recorded"))
        if name in bounds:
            assert prog["host launch calls"] <= bounds[name], (name, prog)
        if name not in same_work:
            continue
        # the same device work: the graph runs some of the forward's copies and
        # fills as kernels, and the eager form copies its result into the static
        # output once more
        work = {form: c["device kernels"] + c["device copies and fills"]
                for form, c in (("eager", eager), ("program", prog))}
        compared = eager["complete"] and prog["complete"]
        if compared:
            assert work["program"] == work["eager"] - 1, (name, eager, prog)
        log(f"[10] {name}: device kernels, copies and fills {work['eager']} eager, "
            f"{work['program']} through the program (the eager form copies its result into "
            "the static output once more): "
            + ("the same work" if compared else "not compared (a profile missed some events)"))
    del staged, groups, stream
    return out


def phase10_profiles(drops: dict, seg: dict, k: dict, ck: dict, fk: dict,
                     corpus: dict) -> None:
    """``torch.profiler`` runs, after every wall: a process that has run the
    profiler launches kernels more slowly from then on, which would load the
    walls of phases 3-9.  One segmented, one monolithic and one time-sharded
    decode, one prestaged ``fused`` decode, one batch of 8 rows and one
    pipelined run of 2 x 8, then the kernels' device times at each phase-2,
    phase-2b and phase-2d shape."""
    from axctdprocessor_tpu_torch.models import engine, segmented
    from axctdprocessor_tpu_torch.ops import chain, tonepower
    from axctdprocessor_tpu_torch.parallel import batch, pipeline, timeshard
    from axctdprocessor_tpu_torch.parallel.mesh import make_mesh

    _profile_high_rate(k, fk, corpus)
    _profile_programs(seg, drops)
    raw, fs = seg["raw"], seg["fs"]
    log("[10] 600 s segmented decode: "
        + profile_run(lambda: segmented.decode_waveform_segmented(raw, fs, device="cuda")))
    staged = segmented.prestage_waveform(raw, fs, device="cuda", fused=True)
    staged.decode()
    staged.decode()  # its program captured: the profile is of a replay
    log("[10] 600 s prestaged decode (fused: every segment in one pass), int8 wire, its "
        "program replayed: " + profile_run(staged.decode))
    del staged
    with _frame_sync_watched() as frame_calls:
        log("[10] 600 s monolithic decode, its program run eagerly: "
            + profile_run(lambda: engine.decode_waveform(raw, fs, device="cuda",
                                                         mode="monolithic")))
    _frame_sync_alone(frame_calls)
    mesh = make_mesh({"dp": 1, "sp": 4}, [torch.device("cuda", 0)] * 4)
    log("[10] 600 s time-sharded decode, dp 1 x sp 4 on the one card: "
        + profile_run(lambda: timeshard.decode_batch_timesharded(raw[None], fs, mesh=mesh)))
    # 8 and 16 of the 64 rows: the launches per row and the idle share are
    # those of the whole batch, and the profiler's own bookkeeping of a
    # quarter of a million launches took half of this script's time
    def batch8():
        return batch.decode_batch(drops["batch"][:8], drops["batch_fs"], device="cuda")

    batch8()
    batch8()  # its program captured: the profile is of a replay
    log("[10] batch 1 x 8 x 60 s, its program replayed: " + profile_run(batch8))
    batches = [(sub, None) for sub in np.split(drops["batch"][:16], 2)]
    log("[10] pipeline 2 x 8 x 60 s: "
        + profile_run(lambda: pipeline.decode_batches_pipelined(batches, drops["batch_fs"],
                                                                device="cuda")))
    texts = []
    for rec, (_, xd, fs) in zip(k["shapes"], _kernel_cases(drops)):
        window, stride, tm = _table(fs)
        rec["device_ms"] = _device_ms(lambda: tonepower.tone_ratios(xd, tm, window, stride),
                                      "tone_ratios_kernel")
        rec["share_of_bound_device"] = (rec["bound_us"] / 1e3 / rec["device_ms"]
                                        if rec["device_ms"] else None)
        rec["dft_core_device_ms"] = _device_total_ms(_frontend_library("tone_powers",
                                                                       (xd, tm, window, stride)))
        texts.append(f"{rec['shape']} at {tuple(rec['block_shape'])}: "
                     + ("not measured" if rec["device_ms"] is None else
                        f"{rec['device_ms']:.4f} ms, share of bound "
                        f"{rec['share_of_bound_device']:.3f}")
                     + _standard_device_text(rec, xd, tm, window, stride)
                     + f", the DFT core's torch.matmul {_ms_text(rec['dft_core_device_ms'])}")
    log("[10] tone_ratios device time (torch.profiler, mean of 20 calls): " + "; ".join(texts))
    # the chain kernels: the main paths' arguments recorded anew (phase 2b
    # kept none, so that no phase between held them on the card)
    recs = {name: iter(r) for name, r in ck.items()}
    floor = _device_total_ms(_empty_kernel, calls=20)
    log("[10] an empty kernel (torch.cuda._sleep(0)), the launch floor: device "
        + ("not measured" if floor is None else f"{floor:.4f} ms"))
    chain_calls = _record_chain_calls(drops)
    for name, shape, meta, fns in _chain_timed(chain_calls):
        rec = next(recs[name])
        assert rec["shape"] == shape, (rec["shape"], shape)
        rec["device_ms"] = _device_ms(fns["kernel"], CHAIN_IN_TRACE[name], calls=10)
        text = ("not measured" if rec["device_ms"] is None else
                f"{rec['device_ms']:.4f} ms, share of bound {meta['bound_ms'] / rec['device_ms']:.4f}")
        if name == "chain_walk_frames":
            rec.update(call_device_ms=_device_total_ms(fns["kernel"]),
                       jump_walk_device_ms=_device_total_ms(fns["jump_walk"]),
                       jump_tables_device_ms=_device_total_ms(fns["jump_tables"]),
                       launch_floor_device_ms=floor)
            text += "; " + "; ".join(f"{what} {_ms_text(rec[key])}" for what, key in (
                ("the whole call (the flags' fill too)", "call_device_ms"),
                ("the jump-table walk's whole call (jump tables + chain_walk)", "jump_walk_device_ms"),
                ("its jump tables alone (jump_levels)", "jump_tables_device_ms"),
                ("an empty kernel", "launch_floor_device_ms")))
        log(f"[10] {name} {shape}: device {text}")
    shape, levels, start, k_walk, first = _chain_walk_args(chain_calls)
    del chain_calls
    rec = ck["chain_walk"][0]
    assert rec["shape"] == shape, (rec["shape"], shape)
    rec["device_ms"] = _device_ms(lambda: chain.chain_walk(levels, start, k_walk, first),
                                  "chain_walk_kernel", calls=10)
    log(f"[10] chain_walk alone {shape}: device {_ms_text(rec['device_ms'])}")
    del levels
    fcalls = _record_frontend_calls(drops)
    recs = {name: iter(r) for name, r in fk["shapes"].items()}
    for name, path, shape, args in _frontend_timed(fcalls):
        rec = next(recs[name])
        assert rec["shape"] == shape, (rec["shape"], shape)
        kernel = _frontend_fns()[name][0]
        rec["device_ms"] = _device_ms(lambda: kernel(*args), FRONTEND_IN_TRACE[name], calls=10)
        rec["share_of_bound_device"] = (rec["bound_ms"] / rec["device_ms"]
                                        if rec["device_ms"] else None)
        rec["library_device_ms"] = _device_total_ms(_frontend_library(name, args))
        text = f"; the library product {_ms_text(rec['library_device_ms'])}"
        if name == "tone_powers":
            from axctdprocessor_tpu_torch.ops.kernels import extension

            warps, wpw = rec["block_shape"]
            streamed = rec["variant"] == "streamed"
            trace = _tone_trace_text(_kernels_run(lambda: kernel(*args)), True, warps, wpw,
                                     streamed)
            _tone_launched(shape, args[2], args[3], True, warps, wpw, streamed)
            rec["shape_device_ms"] = {f"{w}x{p}": _device_ms(lambda s=(w, p): kernel(*args, s),
                                                             FRONTEND_IN_TRACE[name], calls=10)
                                      for w, p in extension().tone_powers_shapes()}
            rec["standard_device_ms"] = next(iter(rec["shape_device_ms"].values()))
            text += (f"; block shape ({warps}, {wpw}), {rec['variant']} table, as the "
                     f"launcher recorded it ({trace}); by block shape: "
                     + ", ".join(f"{k} {_ms_text(v)}" for k, v in rec["shape_device_ms"].items()))
        log(f"[10] {name} {shape}: device " + ("not measured" if rec["device_ms"] is None else
            f"{rec['device_ms']:.4f} ms, share of bound {rec['share_of_bound_device']:.3f}")
            + text)
    log(f"[10] short profiles (device times, kernel names): {PROFILES['taken']} taken, "
        f"{PROFILES['empty']} of them with no device activity recorded, "
        f"{PROFILES['incomplete']} of the device times' with some of the host's "
        f"{PROFILES['queued']} launches, copies and fills not recorded ({PROFILES['unrecorded']} "
        f"in all; each taken again, up to {PROFILE_TRIES} times a measurement: a device time "
        f"counts only a profile that recorded them all)")


def _profile_high_rate(k: dict, fk: dict, corpus: dict) -> None:
    """Phase 10's part of the streamed table (its first profiles): one 88.2
    kHz batch of 8 x 60 s through ``decode_batch``; the streamed kernel's
    device time at each of phase 2's high-rate shapes (the launcher's record
    of the instance it launched must be the streamed one, and so must the
    trace's kernel where the profiler recorded it), with its bound and the
    DFT core's product and, on one row, the standard shape's; then
    ``probe_at``'s device time at phase 2d's 88.2 and 96 kHz batch calls,
    at the launcher's geometry (its record must name it) and at the standard
    one, beside ``frames @ trig``.  Where no profile records every device
    event (``_complete_device_events``) the streamed kernel's device time is
    taken with CUDA events instead and says so."""
    from axctdprocessor_tpu_torch.ops import goertzel, tonepower
    from axctdprocessor_tpu_torch.ops.kernels import extension
    from axctdprocessor_tpu_torch.parallel import batch

    rows = corpus["hr"]["rows"]

    def high_rate():
        return batch.decode_batch(rows, 88200, device="cuda")

    high_rate()
    high_rate()  # its program captured: the profile is of a replay
    log(f"[10] {HIGH_RATE_PATH}, its program replayed: " + profile_run(high_rate))
    for rec, (name, xd, fs) in zip(k["streamed"], _high_rate_cases()):
        assert rec["shape"] == name, (rec["shape"], name)
        window, stride, tm = _table(fs)
        fn = lambda: tonepower.tone_ratios(xd, tm, window, stride)  # noqa: E731
        rec["device_ms"], rec["device_ms_from"] = _device_ms(fn, "tone_ratios_kernel"), "profiler"
        trace = _tone_trace_text(_kernels_run(fn), False, *rec["block_shape"], True)
        _tone_launched(name, window, stride, False, *rec["block_shape"], True)
        if rec["device_ms"] is None:
            rec["device_ms"] = statistics.median(_event_ms(fn, 10) for _ in range(5))
            rec["device_ms_from"] = "CUDA events (no profile recorded every device event)"
        rec["share_of_bound_device"] = (rec["bound_us"] / 1e3 / rec["device_ms"]
                                        if rec["device_ms"] else None)
        rec["dft_core_device_ms"] = _device_total_ms(_frontend_library("tone_powers",
                                                                       (xd, tm, window, stride)))
        log(f"[10] streamed table, {name} (the launcher recorded the streamed instance of "
            f"{tuple(rec['block_shape'])}; {trace}): device {rec['device_ms']:.4f} ms from "
            f"{rec['device_ms_from']}, bound {rec['bound_us']:.1f} us, share of bound "
            f"{rec['share_of_bound_device']:.3f}"
            + _standard_device_text(rec, xd, tm, window, stride)
            + f"; the DFT core's torch.matmul {_ms_text(rec['dft_core_device_ms'])}")
    ext = extension()
    for rec, (name, args) in zip(fk["high_rate"], _high_rate_probe_calls()):
        assert rec["shape"].startswith(name), (rec["shape"], name)
        x, starts, _, trig = args
        rec["device_ms"] = _device_ms(lambda: goertzel.probe_at(*args),
                                      FRONTEND_IN_TRACE["probe_at"], calls=10)
        assert ext.probe_last_launch() == tuple(rec["geometry"]), name
        rec["standard_device_ms"] = _device_ms(
            lambda: ext.probe_at(x, starts, trig, *rec["standard_geometry"]),
            FRONTEND_IN_TRACE["probe_at"], calls=10)
        rec["library_device_ms"] = _device_total_ms(_frontend_library("probe_at", args))
        rec["share_of_bound_device"] = (rec["bound_ms"] / rec["device_ms"]
                                        if rec["device_ms"] else None)
        log(f"[10] probe_at {rec['shape']} ({rec['staged_share']:.3f} of its runs staged at "
            f"{tuple(rec['geometry'])}): device {_ms_text(rec['device_ms'])}, bound "
            f"{1e3 * rec['bound_ms']:.2f} us ({rec['bound_by']}); the standard geometry "
            f"{tuple(rec['standard_geometry'])} ({rec['standard_staged_share']:.3f} staged) "
            f"{_ms_text(rec['standard_device_ms'])}; frames @ trig "
            f"{_ms_text(rec['library_device_ms'])}")


def _standard_device_text(rec: dict, xd, tm, window: int, stride: int) -> str:
    """Where phase 2 found ``tone_ratios`` at a small block shape: the
    device time of the standard shape forced on the same input, into
    ``rec``, and a few words for the log."""
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.ops.kernels import extension

    if rec["block_shape"] == rec["standard_shape"]:
        return ""
    n_win = tonepower.n_windows(xd.shape[-1], window, stride)
    rec["standard_device_ms"] = _device_ms(
        lambda: extension().tone_ratios(xd, tm, window, stride, n_win, *rec["standard_shape"]),
        "tone_ratios_kernel")
    return (f" (the standard shape {tuple(rec['standard_shape'])} "
            f"{_ms_text(rec['standard_device_ms'])})")


def _kernels_run(fn, calls: int = 20) -> list:
    """The names of the kernels that `calls` calls of `fn` launch, from
    ``torch.profiler`` (empty if it recorded no device activity: a profile of
    a single launch comes back empty far more often than one of 20)."""
    prof = _profiled(fn, calls)
    return sorted({e.key for e in prof.key_averages() if e.device_time_total > 0})


def _tone_launched(what, window: int, stride: int, powers: bool, warps: int, wpw: int,
                   streamed: bool) -> None:
    """The instance that this thread's last tone call launched, as the
    extension records it from the instance's template arguments, is the
    expected one."""
    from axctdprocessor_tpu_torch.ops.kernels import extension

    want = (-(-window // stride), powers, warps, wpw, streamed)
    got = tuple(extension().tone_last_launch())
    assert got == want, (what, got, want)


def _tone_trace_text(ran: list, powers: bool, warps: int, wpw: int, streamed: bool) -> str:
    """Where the profiler recorded the call: its one kernel must be the
    instance the launcher recorded; the text says which."""
    if not ran:
        return "the profiler recorded no device activity"
    want = f", {str(powers).lower()}, {warps}, {wpw}, {str(streamed).lower()}>"
    assert len(ran) == 1 and want in ran[0], (want, ran)
    return "the trace names " + ran[0].split("::")[-1].split("(")[0]


def _ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


@contextlib.contextmanager
def _frame_sync_watched():
    """While the block runs: every ``enumerate_frames`` call's arguments
    recorded (yielded list), and ``jump_levels`` counted; no frame-sync call on
    the card may build jump tables."""
    from axctdprocessor_tpu_torch.ops import chain

    made, tables = [], [0]
    enumerate_frames, jump_levels = chain.enumerate_frames, chain.jump_levels

    def recorded(*args, **kwargs):
        made.append((args, kwargs))
        return enumerate_frames(*args, **kwargs)

    def counted(*args, **kwargs):
        tables[0] += 1
        return jump_levels(*args, **kwargs)

    chain.enumerate_frames, chain.jump_levels = recorded, counted
    try:
        with _eager_programs():
            yield made
    finally:
        chain.enumerate_frames, chain.jump_levels = enumerate_frames, jump_levels
    assert made, "no frame-sync call recorded"
    assert tables[0] == 0, f"frame sync built jump tables {tables[0]} times"


def _frame_sync_alone(frame_calls: list) -> None:
    """The largest recorded frame-sync call (the 600 s profile's) alone under
    the profiler: its launches and its gather kernels (``jump_levels`` made six
    of them a call before its tables were dropped; PyTorch's gather and
    scatter share a kernel, so the frame starts' gather and the compaction's
    scatter count here too).  Its one ``chain_walk_frames`` launch is held by
    the wrapper's count, and by the trace where the profiler recorded it."""
    from torch.autograd import DeviceType

    from axctdprocessor_tpu_torch.ops import chain

    args, kwargs = max(frame_calls, key=lambda c: c[0][0].shape[-1])
    before = chain.chain_enumerate_frames.launches
    chain.enumerate_frames(*args, **kwargs)
    assert chain.chain_enumerate_frames.launches == before + 1, "chain_walk_frames launches"
    events = _profiled(lambda: chain.enumerate_frames(*args, **kwargs), cpu=True).events()
    kernels = [e.name for e in events if e.device_type == DeviceType.CUDA]
    launches = sum(e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")) for e in events)
    gathers = sum("gather" in name.lower() for name in kernels)
    frames = sum(CHAIN_IN_TRACE["chain_walk_frames"] in name for name in kernels)
    log(f"[10] frame sync of the 600 s profile alone (enumerate_frames, {len(frame_calls)} calls "
        f"in the decode, none built jump tables, one chain_walk_frames launch by its wrapper's "
        f"count): {launches} kernel launches, "
        + (f"{len(kernels)} device activities, of them {gathers} gather kernels and {frames} "
           "chain_walk_frames" if kernels else "the profiler recorded no device activity"))
    assert frames == 1 or not kernels, kernels


def _agreement(a, b) -> float:
    a, b = set(a), set(b)
    return len(a & b) / max(len(a | b), 1)


ROW_CAP_BIT = 1  # DecodeResult.overflow bit 0: stage 1 dropped crossings


def _gates(res, truth, allow_row_cap: bool = False) -> float:
    """The 600 s drop's gates; returns the share of hexframes in the truth.
    ``allow_row_cap`` lets the stage-1 truncation bit of ``overflow`` pass
    (the int4 wire only, see ``_wire_long_drop``); the edge-table and
    frame-sync bits never do."""
    assert res.status == 2, res.status
    for key in ("serial_no", "probe_code", "max_depth"):
        assert res.metadata[key] == truth[key], (key, res.metadata[key])
    allowed = ROW_CAP_BIT if allow_row_cap else 0
    assert res.overflow & ~allowed == 0, res.overflow
    assert len(res.time) > 1000, len(res.time)
    truth_set = set(truth["frame_hex"])
    in_truth = sum(h in truth_set for h in res.hexframes) / len(res.hexframes)
    assert in_truth > 0.97, in_truth
    return in_truth


def _walls(fn, k: int) -> list[float]:
    out = []
    for _ in range(k):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def phase3_end_to_end(drops: dict) -> dict:
    from axctdprocessor_tpu_torch.models import engine, simulator
    from axctdprocessor_tpu_torch.ops import tonepower

    wav, truth = drops["wav"], drops["truth"]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    res = engine.decode_wav(wav, device="cuda", mode="monolithic")
    first_s = time.perf_counter() - t0
    launches = tonepower.tone_ratios.launches
    counts = read_counts("monolithic 600 s")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    assert launches >= 1, "the monolithic path did not launch the tone_ratios kernel"
    in_truth = _gates(res, truth)

    host = engine.decode_wav(wav, device="cpu", mode="monolithic")
    agree_host = _agreement(res.hexframes, host.hexframes)
    assert res.metadata == host.metadata and agree_host >= 0.99, agree_host
    t0 = time.perf_counter()
    engine.decode_wav(wav, device="cuda", mode="monolithic")  # the shape's program captured
    capture_s = time.perf_counter() - t0

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = engine.decode_wav(wav, device="cuda", mode="monolithic")
        walls.append(time.perf_counter() - t0)
    agree_repeat = _agreement(again.hexframes, res.hexframes)
    assert agree_repeat >= 0.99, agree_repeat
    wall = statistics.median(walls)

    small, small_truth = simulator.synthesize()
    cpu = engine.decode_waveform(small, small_truth["spec"].fs, device="cpu")
    gpu = engine.decode_waveform(small, small_truth["spec"].fs, device="cuda")
    agree_cpu = _agreement(gpu.hexframes, cpu.hexframes)
    assert gpu.metadata == cpu.metadata and agree_cpu >= 0.99, agree_cpu

    from axctdprocessor_tpu_torch.utils.wavio import read_wav_raw16

    raw, fs = read_wav_raw16(wav)
    with count_syncs() as syncs:
        engine.decode_waveform(raw, fs, device="cuda", mode="monolithic")
    log(f"[3] 600 s monolithic decode on the card: status {res.status}, serial "
        f"{res.metadata['serial_no']}, probe {res.metadata['probe_code']}, max depth "
        f"{res.metadata['max_depth']}, overflow {res.overflow}, rows {len(res.time)}, "
        f"frames {len(res.hexframes)}, in truth {in_truth:.4f}, agreement with the CPU "
        f"decode of the same WAV {agree_host:.4f} (metadata equal), repeat agreement "
        f"{agree_repeat:.4f}; "
        f"launches {counts_text(counts)}")
    log(f"[3] first decode {first_s:.3f} s (eager), the capture decode {capture_s:.3f} s, "
        f"warm wall (median of 3, replays) {wall:.4f} s "
        f"{[round(w, 4) for w in walls]}, "
        f"realtime factor {600.0 / wall:.1f}x, "
        f"peak device memory {peak_gib:.2f} GiB, host syncs per decode {syncs['n']}")
    log(f"[3] 50 s default drop: CUDA vs CPU decode hexframe agreement "
        f"{agree_cpu:.4f}, metadata equal, frames {len(gpu.hexframes)}/{len(cpu.hexframes)}")
    return dict(launches=launches, hexframes=res.hexframes, wall=wall)


def phase4_highrate(tmp: str) -> None:
    from axctdprocessor_tpu_torch.models import engine, simulator

    spec = simulator.SimSpec(fs=88200, duration=42.0, profile_start=33.0, seed=31)
    pcm, truth = simulator.synthesize(spec)
    wav = os.path.join(tmp, "hi_88k.wav")
    simulator.write_wav(wav, pcm, spec.fs)
    res = engine.decode_wav(wav, device="cuda")
    assert res.status == 2, res.status
    assert isinstance(res.fs, float) and res.fs == 44100.0, res.fs
    assert res.numpoints == (int(42.0 * 88200) + 1) // 2, res.numpoints
    for key in ("serial_no", "probe_code", "max_depth"):
        assert res.metadata[key] == truth[key], (key, res.metadata[key])
    for key in ("tcoeff", "ccoeff", "zcoeff"):
        assert np.allclose(res.metadata[key], truth[key]), key
    log(f"[4] 88.2 kHz 42 s decode on the card: status {res.status}, fs {res.fs}, "
        f"serial {res.metadata['serial_no']}, frames {len(res.hexframes)}, "
        f"overflow {res.overflow}")


def phase5_cli(tmp: str, wav: str) -> None:
    """The CLI decodes with mode "auto": the 600 s WAV takes the segmented
    engine."""
    out = os.path.join(tmp, "report.txt")
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "axctdprocessor_tpu_torch.cli", "-i", wav, "-o", out, "--quiet"]
    subprocess.run(cmd, cwd=ROOT, check=True, timeout=600)
    cli_s = time.perf_counter() - t0
    text = open(out).read()
    assert "Probe Serial: 00123456" in text
    # the defaults are the card's: with no card visible the same command fails
    blind = subprocess.run(cmd, cwd=ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                           capture_output=True, text=True, timeout=600)
    assert blind.returncode != 0 and "cuda" in blind.stderr, blind.stderr[-500:]
    log(f"[5] CLI subprocess with its defaults (the device engine on the card; segmented "
        f"engine under \"auto\"): report of {text.count(chr(10))} lines, serial found, "
        f"{cli_s:.1f} s; with CUDA_VISIBLE_DEVICES empty the same command exits "
        f"{blind.returncode}")


def phase6_segmented(drops: dict, mono: dict) -> dict:
    from axctdprocessor_tpu_torch.utils.profiling import StageTimer
    from axctdprocessor_tpu_torch.utils.wavio import read_wav_raw16
    from axctdprocessor_tpu_torch.models import engine, segmented
    from axctdprocessor_tpu_torch.ops import tonepower

    wav, truth = drops["wav"], drops["truth"]
    zero_counts()
    t0 = time.perf_counter()
    res = engine.decode_wav(wav, device="cuda")  # "auto": 600 s > 300 s
    first_s = time.perf_counter() - t0
    launches = tonepower.tone_ratios.launches
    counts = read_counts("segmented 600 s")
    assert launches == 0, "the segmented path has no tone-ratio kernel"
    in_truth = _gates(res, truth)
    agree_mono = _agreement(res.hexframes, mono["hexframes"])
    assert agree_mono >= 0.99, agree_mono
    walls = _walls(lambda: engine.decode_wav(wav, device="cuda"), 3)
    wall = statistics.median(walls)
    raw, fs = read_wav_raw16(wav)
    timer = StageTimer()
    with count_syncs() as syncs:
        again = segmented.decode_waveform_segmented(raw, fs, device="cuda", timer=timer)
    assert again.hexframes == res.hexframes
    assert timer.counts["stage_device"] == 1, dict(timer.counts)
    assert not [k for k in timer.counts if k.startswith("program.")], dict(timer.counts)
    staged = {w: _staged_equals_host(raw, fs, w) for w in ("int16", "int8", "int4")}
    log(f"[6] 600 s segmented decode (decode_wav, \"auto\"): status {res.status}, serial "
        f"{res.metadata['serial_no']}, overflow {res.overflow}, rows {len(res.time)}, frames "
        f"{len(res.hexframes)}, in truth {in_truth:.4f}, agreement with the monolithic "
        f"decode {agree_mono:.4f}; launches {counts_text(counts)}")
    log(f"[6] first decode {first_s:.3f} s, warm wall (median of 3) {wall:.4f} s "
        f"{[round(w, 4) for w in walls]} vs "
        f"monolithic {mono['wall']:.4f} s, realtime "
        f"factor {600.0 / wall:.1f}x, host syncs per decode {syncs['n']}; stages "
        f"{ {k: round(v * 1e3, 2) for k, v in timer.totals.items()} } ms")
    log(f"[6] staged on the card, wire: groups {staged}, each byte for byte _chunk_host's, dc "
        f"and peak bit for bit the host's rule for the wire; the warm decode opened "
        f"stage_device once and no program.* span")
    return dict(raw=raw, fs=fs, res=res)


def _staged_equals_host(raw, fs, wire: str) -> int:
    """The int16 drop staged on the card at `wire` (``DropPlan.device_groups``)
    held to the host (:func:`_groups_equal_host`); returns the number of
    groups."""
    from axctdprocessor_tpu_torch.models import segmented
    from axctdprocessor_tpu_torch.utils.profiling import NO_TIMER

    p = segmented._plan_waveform(raw, fs, None, wire, NO_TIMER, "cuda", segmented.GROUP)
    assert p.wire == wire, (p.wire, wire)
    return _groups_equal_host(p, p.device_groups(), raw)


def _groups_equal_host(p, groups, raw) -> int:
    """A staged drop's groups against the host's cut (``_chunk_host``) group
    by group, byte for byte, and its ``dc`` / ``peak`` bit for bit against
    the host's rule for its wire: ``np.float32`` of the float64 mean of the
    wire's samples and of ``max(max, -min, 1)`` (int16, int8), the int4
    encoder's own over the whole drop; returns the number of groups."""
    from axctdprocessor_tpu_torch.models import segmented
    from axctdprocessor_tpu_torch.ops import wire as wire_ops

    for j, group in enumerate(groups):
        assert np.array_equal(group.cpu().numpy(), segmented._chunk_host(p, j)), (p.wire, j)
    if p.wire == "int4":
        enc = wire_ops.chunked_int4_encoder(raw)
        if enc is None:
            packed, dc, peak = wire_ops.quantize_int4_packed_stats(raw)
        else:
            enc.ensure(len(raw))
            packed, dc, peak = enc.packed, enc.dc, enc.peak
        assert np.array_equal(packed, p.pcm)
        dc, peak = np.float32(dc), np.float32(peak)
    else:
        dc = np.float32(np.mean(p.pcm))
        peak = np.float32(max(int(p.pcm.max()), -int(p.pcm.min()), 1))
    assert p.dc.cpu().numpy().tobytes() == dc.tobytes(), (p.wire, p.dc, dc)
    assert p.peak.cpu().numpy().tobytes() == peak.tobytes(), (p.wire, p.peak, peak)
    return len(groups)


def phase7_prestaged(drops: dict, seg: dict) -> None:
    from axctdprocessor_tpu_torch.models import segmented

    raw, fs, truth = seg["raw"], seg["fs"], drops["truth"]
    t0 = time.perf_counter()
    st = segmented.prestage_waveform(raw, fs, device="cuda", wire="int8")
    stage_s = time.perf_counter() - t0
    n_groups = _groups_equal_host(st.plan, st.exts, raw)
    zero_counts()
    res = st.decode()
    counts = read_counts("prestaged 600 s")
    in_truth = _gates(res, truth)
    agree = _agreement(res.hexframes, seg["res"].hexframes)
    assert agree >= 0.99, agree
    walls = _walls(st.decode, 5)
    wall = statistics.median(walls)
    k = 8
    t0 = time.perf_counter()
    outs = [st.dispatch() for _ in range(k)]
    finished = [st.finish(o) for o in outs]
    sustained = (time.perf_counter() - t0) / k
    assert all(f.hexframes == res.hexframes for f in finished)
    with count_syncs() as syncs:
        st.decode()
    fused = segmented.prestage_waveform(raw, fs, device="cuda", wire="int8", fused=True)
    res_f = fused.decode()
    assert res_f.hexframes == res.hexframes and res_f.time == res.time, "fused != unfused"
    assert res_f.metadata == res.metadata
    fused.decode()  # its program captured: the walls replay
    f_wall = statistics.median(_walls(fused.decode, 5))
    log(f"[7] prestaged 600 s (int8 wire, staged in {stage_s:.3f} s): status {res.status}, "
        f"{n_groups} groups byte for byte _chunk_host's, dc and peak bit for bit the host's; "
        f"frames {len(res.hexframes)}, in truth {in_truth:.4f}, agreement with the streamed "
        f"segmented decode {agree:.4f}; warm wall (median of 5) {wall:.4f} s "
        f"{[round(w, 4) for w in walls]}, sustained {sustained:.4f} s per decode over {k} "
        f"queued decodes ({600.0 / sustained:.1f}x realtime), host syncs per decode "
        f"{syncs['n']}; fused=True equal to fused=False, warm wall {f_wall:.4f} s; launches "
        f"{counts_text(counts)}")


def phase8_stream(drops: dict) -> None:
    from axctdprocessor_tpu_torch.utils.wavio import read_wav
    from axctdprocessor_tpu_torch.models import segmented
    from axctdprocessor_tpu_torch.models.stream_device import DeviceStreamDecoder

    pcm, fs = read_wav(drops["wav"])
    offline = segmented.decode_waveform_segmented(pcm, fs, device="cuda")
    _gates(offline, drops["truth"])
    dec = DeviceStreamDecoder(fs, device="cuda")
    step = int(fs)
    zero_counts()
    t_feed = time.perf_counter()
    for i in range(0, len(pcm), step):
        dec.feed(pcm[i: i + step])
    t0 = time.perf_counter()
    res = dec.finalize()
    tail_s = time.perf_counter() - t0
    counts = read_counts("stream 600 s")
    feed_s = t0 - t_feed
    assert res.hexframes == offline.hexframes, "stream != offline segmented"
    assert res.time == offline.time and res.metadata == offline.metadata
    log(f"[8] stream: 600 s fed in 1 s float blocks ({feed_s:.3f} s of feeding, "
        f"{dec._next_k} segments); finalize() equal to the offline segmented decode "
        f"({len(res.hexframes)} frames, {len(res.time)} rows); last feed to finalize "
        f"{tail_s:.4f} s; launches {counts_text(counts)}")


def phase9_batch(drops: dict) -> dict:
    from axctdprocessor_tpu_torch.parallel import batch

    rows, fs, truth = drops["batch"], drops["batch_fs"], drops["batch_truth"]

    def check(results, b):
        assert len(results) == b
        for r in results:
            assert r.status == 2, r.status
            assert r.metadata["serial_no"] == truth["serial_no"]

    out, kept = {}, {}
    for name, subs in (("1 x 64", [rows]), ("8 x 8", np.split(rows, 8))):
        for _ in range(2):  # warm-up; the second captures the shape's program
            batch.decode_batch(subs[0], fs, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kept[name] = []
        t0 = time.perf_counter()
        for sub in subs:
            zero_counts()
            kept[name] += batch.decode_batch(sub, fs, device="cuda")
            counts = read_counts(f"decode_batch of {len(sub)} rows")
            # per batch: one tone-ratio launch, the bit-edge chain's three,
            # three frame-sync walks (the profile's and the two headers')
            assert counts["tone_ratios"] == 1, counts
            assert counts["chain_walk_segments"] == 3 and counts["chain_walk_frames"] == 3, counts
        wall = time.perf_counter() - t0
        check(kept[name], len(rows))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[name] = wall
        log(f"[9] batch {name} x 60 s int16: every row status 2 and serial = truth, one "
            f"tone_ratios launch, three of the bit-edge chain and three frame-sync walks per "
            f"decode_batch call (launches {counts_text(counts)}); wall {wall:.3f} s "
            f"({64 * 60.0 / wall:.1f}x realtime), peak device memory {peak:.2f} GiB")
    with count_syncs() as syncs:
        res_out, ctx = batch.dispatch_batch(rows, fs, device="cuda")
    n_dispatch = syncs["n"]
    check(batch.finish_dispatched(res_out, ctx), 64)
    log(f"[9] host syncs in dispatch_batch of 64: {n_dispatch} (it queues the batch's one "
        f"device-to-host copy on a side stream; finish_dispatched waits on that copy's event)")
    log(f"[9] program cache after the batches of 64 and of 8 rows: {cache_text()}")
    return dict(launches=1, rows_8x8=kept["8 x 8"], wall_8x8=out["8 x 8"])


def _rows_equal(got, want, truth, name) -> None:
    assert len(got) == len(want), (name, len(got), len(want))
    for i, (r, ref) in enumerate(zip(got, want)):
        assert r.status == 2 and r.overflow == 0, (name, i, r.status, r.overflow)
        assert r.metadata["serial_no"] == truth["serial_no"], (name, i)
        assert r.hexframes == ref.hexframes and r.metadata == ref.metadata, (name, i)
        assert r.time == ref.time, (name, i)


def phase9a_pipeline(drops: dict, bat: dict) -> dict:
    """The 64 rows as 8 batches of 8 through the two-stage pipeline; every
    row against the same row of phase 9's ``decode_batch`` 8 x 8 (the same
    card, kernel and arithmetic: equal)."""
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.parallel import batch, pipeline

    rows, fs, truth = drops["batch"], drops["batch_fs"], drops["batch_truth"]
    n_b = len(rows) // 8
    batches = [(sub, None) for sub in np.split(rows, n_b)]

    def run():
        return pipeline.decode_batches_pipelined(batches, fs, device="cuda")

    zero_counts()
    t0 = time.perf_counter()
    out = run()
    first_s = time.perf_counter() - t0
    launches = tonepower.tone_ratios.launches
    counts = read_counts(f"pipeline {n_b} x 8")
    assert launches == n_b, f"{launches} tone_ratios launches for {n_b} pipelined batches"
    assert counts["chain_walk_segments"] == 3 * n_b, counts
    flat = [r for b in out for r in b]
    assert [len(b) for b in out] == [8] * n_b
    _rows_equal(flat, bat["rows_8x8"], truth, "pipeline")

    def plain():
        for sub, _ in batches:
            batch.decode_batch(sub, fs, device="cuda")

    walls, plain_walls = [], []
    for _ in range(3):  # in turns: decode_batch batch by batch, then the pipeline
        plain_walls += _walls(plain, 1)
        walls += _walls(run, 1)
    wall, plain_wall = statistics.median(walls), statistics.median(plain_walls)
    with count_syncs() as syncs:
        run()
    log(f"[9a] pipeline {n_b} x 8 x 60 s int16 (decode_batches_pipelined): {len(flat)} rows "
        f"status 2, serial = truth, overflow 0, hexframes, metadata and time equal to decode_batch "
        f"8 x 8 row for row; launches {counts_text(counts)} (one tone_ratios and one bit-edge "
        f"walk per batch)")
    log(f"[9a] first run {first_s:.3f} s, warm wall (median of 3) {wall:.3f} s "
        f"{[round(w, 3) for w in walls]} ({len(flat) * 60.0 / wall:.1f}x realtime) beside "
        f"decode_batch batch by batch in turns with it {plain_wall:.3f} s "
        f"{[round(w, 3) for w in plain_walls]} ({bat['wall_8x8']:.3f} s in phase 9); host "
        f"syncs seen by torch's sync debug mode in one run of {n_b} batches: {syncs['n']} "
        f"(the fetch waits on one CUDA event per batch, which that mode does not count)")
    return dict(launches=launches, rows=flat, wall=wall)


ECHO_DEAD = b"Dead frequency: 3000.0\n", b"Dead frequency: 3000\n"  # the CLI's -d is a float


def phase9b_archive(tmp: str, drops: dict, piped: dict) -> dict:
    """The 64 rows as WAVs plus one truncated file through the archive
    runner, against phase 9a's results; then resume, then the CLI."""
    from scipy.io import wavfile

    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.parallel.archive import reprocess_corpus
    from axctdprocessor_tpu_torch.utils.config import resolve_settings
    from axctdprocessor_tpu_torch.utils.profiling import StageTimer
    from axctdprocessor_tpu_torch.utils.report import write_report

    rows, fs = drops["batch"], int(drops["batch_fs"])
    corpus = os.path.join(tmp, "corpus")
    os.makedirs(corpus)
    paths = []
    for i, row in enumerate(rows):
        paths.append(os.path.join(corpus, f"row{i:02d}.wav"))
        wavfile.write(paths[-1], fs, row)
    nbytes = sum(os.path.getsize(p) for p in paths)
    cut = os.path.join(corpus, "truncated.wav")
    with open(paths[0], "rb") as f, open(cut, "wb") as g:
        g.write(f.read(30))  # ends inside the format chunk
    out_dir = os.path.join(tmp, "archive_out")
    timer = StageTimer()
    zero_counts()
    with count_syncs() as syncs:
        t0 = time.perf_counter()
        manifest = reprocess_corpus(paths + [cut], out_dir, batch_size=8, device="cuda",
                                    timer=timer)
        wall = time.perf_counter() - t0
    launches = tonepower.tone_ratios.launches
    counts = read_counts("archive 8 x 8")
    n = len(rows)
    assert launches == n // 8, f"{launches} tone_ratios launches for {n // 8} archive batches"
    status = {k: v["status"] for k, v in manifest["files"].items()}
    assert status.pop("truncated.wav") == "failed", manifest["files"]["truncated.wav"]
    assert len(status) == n and set(status.values()) == {"done"}, status
    cfg = resolve_settings(None)
    echo = {"minR400": cfg.min_r400, "mindR7500": cfg.min_dr7500, "deadfreq": cfg.dead_freq,
            "pointsperloop": 100000, "triggerrange": list(cfg.trigger_range)}
    want = os.path.join(tmp, "want.txt")
    for path, res in zip(paths, piped["rows"]):
        write_report(want, res, path, [0, -1], echo, cfg)
        got = os.path.join(out_dir, os.path.basename(path)[:-4] + ".txt")
        assert open(got, "rb").read() == open(want, "rb").read(), path
        assert manifest["files"][os.path.basename(path)]["wire"] == "int16"

    again = StageTimer()
    tonepower.tone_ratios.launches = 0
    m2 = reprocess_corpus(paths, out_dir, batch_size=8, device="cuda", timer=again)
    # a resumed pass plans its batches and saves its manifest, and decodes nothing
    assert tonepower.tone_ratios.launches == 0, tonepower.tone_ratios.launches
    assert set(again.counts) <= {"plan_batches", "io.save_manifest"}, again.counts
    assert all(m2["files"][k]["finished_at"] == manifest["files"][k]["finished_at"]
               for k in status)

    cli_out = os.path.join(tmp, "archive_cli_out")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "axctdprocessor_tpu_torch.cli", "--corpus", corpus,
                    "-o", cli_out, "--batch-size", "8", "--device", "cuda", "--quiet"],
                   cwd=ROOT, check=True, timeout=600)
    cli_s = time.perf_counter() - t0
    cli_manifest = json.load(open(os.path.join(cli_out, "manifest.json")))
    assert sorted(v["status"] for v in cli_manifest["files"].values()) == \
        ["done"] * n + ["failed"]
    for path in paths:
        name = os.path.basename(path)[:-4] + ".txt"
        assert open(os.path.join(cli_out, name), "rb").read().replace(*ECHO_DEAD) == \
            open(os.path.join(out_dir, name), "rb").read(), name
    stages = {k: round(v, 4) for k, v in timer.totals.items()}
    log(f"[9b] archive: {n} int16 WAVs of 60 s ({nbytes / 1e6:.0f} MB) + 1 truncated file, "
        f"reprocess_corpus(batch_size=8, device=\"cuda\"): {n} done, 1 failed, every report "
        f"byte-equal to write_report of the pipeline's row; launches {counts_text(counts)} "
        f"(one tone_ratios per batch); resume=True decoded nothing")
    log(f"[9b] wall {wall:.3f} s, {n / wall:.2f} drops/s ({n * 60.0 / wall:.1f}x realtime); "
        f"stage times (s) {stages}; host syncs seen by torch's sync debug mode in the whole "
        f"run: {syncs['n']} ({n // 8} batches; each fetch waits on one CUDA event, which that "
        f"mode does not count)")
    log(f"[9b] CLI subprocess (--corpus, --batch-size 8, --device cuda): {n} done, 1 failed, "
        f"reports equal to the API run's, {cli_s:.1f} s with interpreter start and kernel load")
    return dict(launches=launches, wall=wall)


def phase9c_parity(tmp: str, drops: dict, mono: dict) -> None:
    """The host parity engine through the CLI, and the bench's correctness
    gate: the card's decode against the parity decode."""
    from axctdprocessor_tpu_torch.models import engine, parity_engine, simulator

    pcm, truth = simulator.synthesize()
    wav = os.path.join(tmp, "default_50s.wav")
    simulator.write_wav(wav, pcm, truth["spec"].fs)
    out = os.path.join(tmp, "parity_report.txt")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "axctdprocessor_tpu_torch.cli", "-i", wav, "-o", out,
                    "--engine", "parity", "--quiet"], cwd=ROOT, check=True, timeout=600)
    cli_s = time.perf_counter() - t0
    text = open(out).read()
    assert "Probe Serial: 00123456" in text and text.count("\n") > 200
    par = parity_engine.decode_wav(wav)
    assert par.status == 2 and par.wire is None
    gpu = engine.decode_wav(wav, device="cuda", mode="monolithic")
    agree = _agreement(gpu.hexframes, par.hexframes)
    assert agree >= 0.99 and gpu.metadata == par.metadata, agree
    log(f"[9c] CLI subprocess (--engine parity, 50 s default drop, host only): report of "
        f"{text.count(chr(10))} lines, serial found, {cli_s:.1f} s; hexframe agreement of the "
        f"card's monolithic decode with the parity decode {agree:.4f} "
        f"({len(gpu.hexframes)}/{len(par.hexframes)} frames), metadata equal")
    t0 = time.perf_counter()
    par600 = parity_engine.decode_wav(drops["wav"])
    par_s = time.perf_counter() - t0
    assert par600.status == 2 and len(par600.hexframes) > 1000
    agree600 = _agreement(mono["hexframes"], par600.hexframes)
    assert agree600 >= 0.99, agree600
    log(f"[9c] 600 s bench drop: parity decode on the host {par_s:.1f} s, "
        f"{len(par600.hexframes)} frames; hexframe agreement of phase 3's monolithic decode "
        f"with it {agree600:.4f} (gate 0.99)")


def phase9d_multi_device(drops: dict, mono: dict, bat: dict, piped: dict) -> dict:
    """The mesh paths with every place of each mesh on the one card: what
    they compute and what they cost there.  A speed-up over several cards
    and the ordering of copies between two cards need more than one."""
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.parallel import batch, pipeline, timeshard
    from axctdprocessor_tpu_torch.parallel.mesh import make_mesh
    from axctdprocessor_tpu_torch.utils.wavio import read_wav_raw16

    card = torch.device("cuda", 0)
    log("[9d] one card: every mesh here is make_mesh(shape, [cuda:0] * k), the same device "
        "at every place, by the caller's explicit list")
    mesh = make_mesh({"dp": 1, "sp": 4}, [card] * 4)

    def long_drop():
        # WAV read to DecodeResult, as phase 3's decode_wav walls are
        raw, fs = read_wav_raw16(drops["wav"])
        return timeshard.decode_batch_timesharded(raw[None], fs, mesh=mesh)[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    res = long_drop()
    first_s = time.perf_counter() - t0
    ts_launches = tonepower.tone_ratios.launches
    ts_counts = read_counts("time-sharded 600 s, dp 1 x sp 4")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    assert ts_launches == 0, "the time-sharded front end has no tone-ratio kernel"
    in_truth = _gates(res, drops["truth"])
    agree_mono = _agreement(res.hexframes, mono["hexframes"])
    assert agree_mono >= 0.99, agree_mono
    from axctdprocessor_tpu_torch.models import engine

    def mono_drop():
        return engine.decode_wav(drops["wav"], device="cuda", mode="monolithic")

    walls, mono_walls = [], []
    for _ in range(3):  # in turns: walls drift within a process
        mono_walls += _walls(mono_drop, 1)
        walls += _walls(long_drop, 1)
    wall, mono_wall = statistics.median(walls), statistics.median(mono_walls)
    with count_syncs() as syncs:
        again = long_drop()
    assert again.hexframes == res.hexframes, "two time-sharded decodes differ"
    log(f"[9d] 600 s int16 drop, decode_batch_timesharded on dp 1 x sp 4: status {res.status}, "
        f"serial {res.metadata['serial_no']}, probe {res.metadata['probe_code']}, max depth "
        f"{res.metadata['max_depth']}, overflow {res.overflow}, rows {len(res.time)}, frames "
        f"{len(res.hexframes)}, in truth {in_truth:.4f}, agreement with the monolithic decode "
        f"{agree_mono:.4f} (gate 0.99); launches {counts_text(ts_counts)}")
    log(f"[9d] first decode {first_s:.3f} s, warm wall (median of 3) {wall:.4f} s "
        f"{[round(w, 4) for w in walls]}, the WAV's read included, in turns with the "
        f"monolithic decode {mono_wall:.4f} s {[round(w, 4) for w in mono_walls]} "
        f"({wall / mono_wall:.2f}x; {mono['wall']:.4f} s in phase 3), realtime factor {600.0 / wall:.1f}x, peak device "
        f"memory {peak_gib:.2f} GiB, host syncs per decode {syncs['n']}")

    rows, bfs, truth = drops["batch"], drops["batch_fs"], drops["batch_truth"]
    got = timeshard.decode_batch_timesharded(
        rows[:4], bfs, mesh=make_mesh({"dp": 2, "sp": 2}, [card] * 4))
    agrees = []
    for i, (r, ref) in enumerate(zip(got, bat["rows_8x8"])):
        assert r.status == 2 and r.overflow == 0, (i, r.status, r.overflow)
        assert r.metadata["serial_no"] == truth["serial_no"], i
        agrees.append(_agreement(r.hexframes, ref.hexframes))
    assert len(got) == 4 and min(agrees) >= 0.99, agrees
    log(f"[9d] 4 x 60 s int16 rows, decode_batch_timesharded on dp 2 x sp 2: every row status "
        f"2, serial = truth, overflow 0; hexframe agreement with decode_batch's rows "
        f"{[round(a, 4) for a in agrees]} (gate 0.99)")

    dp2 = make_mesh({"dp": 2}, [card] * 2)
    zero_counts()
    t0 = time.perf_counter()
    got = batch.decode_batch(rows[:16], bfs, mesh=dp2)
    dp_wall = time.perf_counter() - t0
    dp_launches = tonepower.tone_ratios.launches
    dp_counts = read_counts("decode_batch, mesh dp 2, 16 rows")
    assert dp_launches == 2, f"{dp_launches} tone_ratios launches for 2 dp runs"
    _rows_equal(got, bat["rows_8x8"][:16], truth, "dp batch")
    log(f"[9d] 16 x 60 s rows, decode_batch(mesh=dp 2): every row equal to decode_batch's "
        f"(hexframes, metadata, time); launches {counts_text(dp_counts)} (one tone_ratios per "
        f"dp run); "
        f"wall {dp_wall:.3f} s")

    batches = [(sub, None) for sub in np.split(rows, 8)[:2]]
    zero_counts()
    t0 = time.perf_counter()
    out = pipeline.decode_batches_pipelined(batches, bfs, devices=[card, card])
    pipe_wall = time.perf_counter() - t0
    pipe_launches = tonepower.tone_ratios.launches
    pipe_counts = read_counts("pipeline on two devices, 2 x 8")
    assert pipe_launches == 2, f"{pipe_launches} tone_ratios launches for 2 pipelined batches"
    _rows_equal([r for b in out for r in b], piped["rows"][:16], truth, "two-device pipeline")
    log(f"[9d] 2 x 8 x 60 s, decode_batches_pipelined(devices=[cuda:0, cuda:0]): every row "
        f"equal to the one-device pipeline's; launches {counts_text(pipe_counts)} (one "
        f"tone_ratios per batch); wall {pipe_wall:.3f} s")
    return dict(timeshard_launches=ts_launches, dp_launches=dp_launches,
                pipe_launches=pipe_launches)


WIRES = ("int16", "int8", "int4")
DEV = "cuda"  # the device of the wire phase's tensors and decodes


def _h2d_ms(nbytes: int) -> float:
    """Median CUDA-event time of one pinned host-to-device copy of `nbytes`."""
    host = torch.empty(nbytes, dtype=torch.uint8).pin_memory()
    host.to(DEV, non_blocking=True)
    return statistics.median(_event_ms(lambda: host.to(DEV, non_blocking=True))
                             for _ in range(5))


def _wire_tensors(raw: np.ndarray, rows: np.ndarray) -> None:
    """Item 1 of the wire phase: ``unpack_int4`` and ``condition_integer`` on
    the card against the CPU, on the host's encodings of the 600 s drop, of
    an odd length and of 8 archive rows."""
    from axctdprocessor_tpu_torch.models import engine
    from axctdprocessor_tpu_torch.ops import wire as wire_ops

    def both(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t, t.to(DEV)

    n = len(raw)
    odd = raw[: 1_000_001]
    cases = [("600 s", wire_ops.encode(raw, "int4"), n),
             ("odd n", wire_ops.encode(odd, "int4"), len(odd)),
             ("8 rows", wire_ops.quantize_int4_packed_rows(rows[:8]), rows.shape[1])]
    for name, packed, width in cases:
        assert packed.dtype == np.uint8 and packed.shape[-1] == (width + 1) // 2, name
        cpu, card = both(packed)
        u_cpu, u_card = engine.unpack_int4(cpu, width), engine.unpack_int4(card, width)
        assert u_card.dtype == torch.int32 and u_card.shape[-1] == width, name
        assert torch.equal(u_card.cpu(), u_cpu), f"unpack_int4 differs on the card: {name}"
        assert int(u_cpu.abs().max()) <= 7, name
    q_cpu, q_card = both(wire_ops.quantize_int8_rows(rows[:8]))
    assert torch.equal(q_card.to(torch.int32).cpu(), q_cpu.to(torch.int32))
    seen = {}
    for w in ("int8", "int4"):
        cpu, card = both(wire_ops.encode(raw, w))
        if w == "int4":
            cpu, card = engine.unpack_int4(cpu, n), engine.unpack_int4(card, n)
        c_cpu = engine.condition_integer(cpu, n, torch.full((), n))
        c_card = engine.condition_integer(card, n, torch.full((), n, device=DEV))
        seen[w] = float((c_card.cpu() - c_cpu).abs().max())
        assert torch.equal(c_card.cpu(), c_cpu), (w, seen[w])
    log(f"[9e] unpack_int4 on the card bit-equal to the CPU: the 600 s drop ({n} samples), an "
        f"odd n ({len(odd)}), 8 archive rows (quantize_int4_packed_rows); quantize_int8_rows "
        f"as int32 equal; condition_integer on the card equal to the CPU at int8 and int4 "
        f"(the DC mean is an exact sum; max abs difference {seen['int8']:.3g}, "
        f"{seen['int4']:.3g})")


def _wire_long_drop(drops: dict, raw: np.ndarray, fs) -> dict:
    """Item 2: the 600 s WAV through ``decode_wav`` at every wire, monolithic
    and segmented.  Returns the decodes by (mode, wire).

    At int4 the quiet lead-in before the first pulse quantizes to the zero
    level, so the filtered signal there is a constant of about 1e-6 under
    the FFT's own rounding noise, whose sign flips are counted as
    crossings: where one 128-sample row collects more than the row cap of
    16, stage 1 drops the extra ones and raises bit 0 of ``overflow``.
    Whether a row does depends on the FFT's rounding (the card's and the
    CPU's differ).  That bit is reported and allowed at int4 and at no
    other wire; every other gate holds at every wire."""
    from axctdprocessor_tpu_torch.models import engine, segmented
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.utils.profiling import StageTimer

    wav, truth = drops["wav"], drops["truth"]
    item = {"int16": 2.0, "int8": 1.0, "int4": 0.5}
    _, _, seg_len, right, _ = segmented._seg_geometry(float(fs))
    seg_bytes = -(-len(raw) // seg_len) * (segmented.LEFT_HALO + seg_len + right)
    kept = {}
    for mode in ("monolithic", "segmented"):
        first = {}
        for w in WIRES:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tonepower.tone_ratios.launches = 0
            res = engine.decode_wav(wav, device=DEV, wire=w, mode=mode)
            launches = tonepower.tone_ratios.launches
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            assert res.wire == w, (mode, w, res.wire)
            assert launches == (1 if mode == "monolithic" else 0), (mode, w, launches)
            in_truth = _gates(res, truth, allow_row_cap=w == "int4")
            agree = _agreement(res.hexframes, kept.get((mode, "int16"), res).hexframes)
            assert agree >= 0.99, (mode, w, agree)
            kept[mode, w] = res
            first[w] = (in_truth, agree, peak, launches)
        walls = {w: [] for w in WIRES}
        stages = {w: [] for w in WIRES}
        for w in WIRES:  # each wire's program captured: the walls replay
            engine.decode_wav(wav, device=DEV, wire=w, mode=mode)
        for _ in range(3):  # in turns: walls drift within a process
            for w in WIRES:
                timer = StageTimer()
                walls[w] += _walls(lambda: engine.decode_wav(
                    wav, device=DEV, wire=w, mode=mode, timer=timer), 1)
                stages[w].append(dict(timer.totals))
        for w in WIRES:
            in_truth, agree, peak, launches = first[w]
            nbytes = int((len(raw) if mode == "monolithic" else seg_bytes) * item[w])
            enc = [1e3 * (s.get("host_encode_stats", 0.0) + s.get("encode_chunks", 0.0))
                   for s in stages[w]]
            up = [1e3 * s.get("build_upload", 0.0) for s in stages[w]]
            log(f"[9e] 600 s {mode} at wire {w}: status 2, serial, probe and max depth = truth, "
                f"overflow {kept[mode, w].overflow}, rows {len(kept[mode, w].time)}, frames "
                f"{len(kept[mode, w].hexframes)}, in truth {in_truth:.4f}, agreement with the "
                f"int16 decode {agree:.4f} (gate 0.99), res.wire {kept[mode, w].wire}, "
                f"tone_ratios launches {launches}; warm wall (median of 3, in turns) "
                f"{statistics.median(walls[w]):.4f} s {[round(x, 4) for x in walls[w]]}, host "
                f"encode {statistics.median(enc):.2f} ms {[round(x, 2) for x in enc]}, build + "
                f"pin + queue the upload {statistics.median(up):.2f} ms, H2D {nbytes} bytes "
                f"{_h2d_ms(nbytes):.3f} ms (one pinned copy of that size), peak device memory "
                f"{peak:.2f} GiB")
    return kept


def _wire_rows(tmp: str, drops: dict) -> list:
    """Item 3: the 64 noisy archive rows through ``decode_batch`` 8 x 8 at
    every wire with the int8 retry on, then at int4 through the pipeline and
    the archive runner.  Returns the indices of the rows the retry decoded
    again."""
    from scipy.io import wavfile

    from axctdprocessor_tpu_torch.models import engine
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.parallel import batch, pipeline
    from axctdprocessor_tpu_torch.parallel.archive import reprocess_corpus
    from axctdprocessor_tpu_torch.utils.config import DecoderConfig, resolve_settings
    from axctdprocessor_tpu_torch.utils.report import write_report

    rows, fs, truth = drops["batch"], drops["batch_fs"], drops["batch_truth"]
    subs = np.split(rows, 8)
    cfg = DecoderConfig()
    out, runs = {}, {w: [] for w in WIRES}
    for w in WIRES:
        for _ in range(2):  # warm-up; the second captures the wire's program
            batch.decode_batch(subs[0], fs, device=DEV, wire=w)
    for turn in range(3):  # in turns: walls drift within a process
        for w in WIRES:
            if w == "int4" and turn:  # at over twice the wall, once tells enough
                continue
            torch.cuda.synchronize()
            tonepower.tone_ratios.launches = 0
            t0 = time.perf_counter()
            res = [r for sub in subs for r in batch.decode_batch(sub, fs, device=DEV, wire=w)]
            runs[w].append((time.perf_counter() - t0, tonepower.tone_ratios.launches, res))
    for w in WIRES:
        walls = [run[0] for run in runs[w]]
        wall, (_, launches, res) = statistics.median(walls), runs[w][0]
        assert all([r.wire for r in run[2]] == [r.wire for r in res] for run in runs[w]), w
        retried = [i for i, r in enumerate(res) if r.wire != w]
        for i, r in enumerate(res):
            allowed = ROW_CAP_BIT if r.wire == "int4" else 0  # see _wire_long_drop
            assert r.status == 2 and r.overflow & ~allowed == 0, (w, i, r.status, r.overflow)
            assert r.metadata["serial_no"] == truth["serial_no"], (w, i)
            assert r.wire == ("int8" if i in retried else w), (w, i, r.wire)
            assert not engine.lossy_retry_worthy(r, rows.shape[1], float(fs), cfg), (w, i)
        assert w == "int4" or not retried, (w, retried)
        redone_batches = len({i // 8 for i in retried})
        assert launches == 8 + redone_batches, (w, launches, redone_batches)
        agrees = [_agreement(r.hexframes, ref.hexframes)
                  for r, ref in zip(res, out.get("int16", (res,))[0])]
        assert statistics.mean(agrees) >= 0.99 and min(agrees) >= 0.97, (w, min(agrees))
        out[w] = (res, wall)
        log(f"[9e] 64 x 60 s noisy rows, decode_batch 8 x 8 at wire {w}, lossy_retry on: every "
            f"row status 2, serial = truth, rows with the row-cap bit of overflow "
            f"{sum(r.overflow != 0 for r in res)}, no other bit; rows decoded again at int8: "
            f"{len(retried)} {retried} (each comes back wire int8, in {redone_batches} batches); "
            f"tone_ratios launches {launches} (8 + one per batch with a retry); hexframe "
            f"agreement with the int16 rows mean {statistics.mean(agrees):.4f} min "
            f"{min(agrees):.4f} (gates 0.99 and 0.97); wall (median of {len(walls)}, in turns) "
            f"{wall:.3f} s {[round(x, 3) for x in walls]} ({64 * 60.0 / wall:.1f}x realtime)")
    want, _ = out["int4"]
    retried = [i for i, r in enumerate(want) if r.wire == "int8"]
    with count_syncs() as syncs:
        q_out, ctx = batch.dispatch_batch(subs[0], fs, device=DEV, wire="int4")
    first = batch.finish_dispatched(q_out, ctx)
    with count_syncs() as retry_syncs:
        batch.retry_lossy_rows(first, subs[0], fs, device=DEV)
    log(f"[9e] host syncs in dispatch_batch of 8 rows at int4: {syncs['n']}; in "
        f"retry_lossy_rows of that batch ({sum(i < 8 for i in retried)} rows decoded again): "
        f"{retry_syncs['n']}")
    assert syncs["n"] == 0, syncs["n"]

    def same(got, name):
        assert len(got) == len(want), name
        for i, (r, ref) in enumerate(zip(got, want)):
            assert (r.status, r.wire, r.overflow) == (ref.status, ref.wire, ref.overflow), (name, i)
            assert r.hexframes == ref.hexframes and r.metadata == ref.metadata, (name, i)
            assert r.time == ref.time, (name, i)

    t0 = time.perf_counter()
    piped = pipeline.decode_batches_pipelined([(sub, None) for sub in subs], fs, device=DEV,
                                              wire="int4")
    pipe_wall = time.perf_counter() - t0
    same([r for b in piped for r in b], "pipeline at int4")

    corpus = os.path.join(tmp, "corpus")  # the archive phase's WAVs, where it ran
    os.makedirs(corpus, exist_ok=True)
    paths = [os.path.join(corpus, f"row{i:02d}.wav") for i in range(len(rows))]
    for path, row in zip(paths, rows):
        if not os.path.exists(path):
            wavfile.write(path, int(fs), row)
    out_dir = os.path.join(tmp, "archive_out_int4")
    t0 = time.perf_counter()
    manifest = reprocess_corpus(paths, out_dir, batch_size=8, device=DEV, wire="int4")
    corpus_wall = time.perf_counter() - t0
    rcfg = resolve_settings(None)
    echo = {"minR400": rcfg.min_r400, "mindR7500": rcfg.min_dr7500, "deadfreq": rcfg.dead_freq,
            "pointsperloop": 100000, "triggerrange": list(rcfg.trigger_range)}
    ref_txt = os.path.join(tmp, "want_int4.txt")
    for path, res in zip(paths, want):
        write_report(ref_txt, res, path, [0, -1], echo, rcfg)
        name = os.path.basename(path)
        got = os.path.join(out_dir, name[:-4] + ".txt")
        assert open(got, "rb").read() == open(ref_txt, "rb").read(), path
        entry = manifest["files"][name]
        assert entry["status"] == "done" and entry["wire"] == res.wire, (name, entry)
    log(f"[9e] the same rows at int4 through decode_batches_pipelined (wall {pipe_wall:.3f} s) "
        f"and reprocess_corpus(batch_size=8, wire=\"int4\") (wall {corpus_wall:.3f} s, "
        f"{len(rows) / corpus_wall:.2f} drops/s): rows (status, wire, hexframes, metadata, "
        f"time) and report bytes equal to decode_batch's at int4; the manifest records "
        f"{sum(v['wire'] == 'int8' for v in manifest['files'].values())} files as int8, the "
        f"rest as int4")
    return retried


def _wire_forced_retry(drops: dict, retried: list) -> int:
    """Item 4: one drop that collapses at int4 on the card through
    ``decode_waveform`` with and without the retry.  Returns the kernel's
    launch count of the retried decode."""
    from axctdprocessor_tpu_torch.models import engine, simulator
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.utils.config import DecoderConfig

    cfg = DecoderConfig()
    fs = drops["batch_fs"]

    def candidates():
        for i in retried[:2]:
            yield f"archive row {i} (60 s, seed 21, +-300 of noise)", drops["batch"][i]
        for seed, amp in ((11, 1.0), (11, 0.5), (3, 0.5), (5, 0.3), (7, 0.2)):
            spec = simulator.SimSpec(duration=60.0, profile_start=40.0, seed=seed, fsk_amp=amp)
            pcm, _ = simulator.synthesize(spec)
            yield (f"60 s drop of seed {seed}, profile at 40 s, fsk_amp {amp}",
                   np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16))

    for name, pcm in candidates():
        bare = engine.decode_waveform(pcm, fs, device=DEV, wire="int4", lossy_retry=False)
        assert bare.wire == "int4", bare.wire
        if not engine.lossy_retry_worthy(bare, len(pcm), float(fs), cfg):
            log(f"[9e] {name}: decodes at int4 on the card ({len(bare.hexframes)} frames), "
                f"not a collapse")
            continue
        zero_counts()
        res = engine.decode_waveform(pcm, fs, device=DEV, wire="int4", lossy_retry=True)
        launches = tonepower.tone_ratios.launches
        counts = read_counts("int4 decode with its int8 retry")
        assert res.wire == "int8" and res.status == 2, (res.wire, res.status)
        assert res.metadata["serial_no"] == "00123456", res.metadata["serial_no"]
        assert len(res.hexframes) > 4 * max(len(bare.hexframes), 1), \
            (len(res.hexframes), len(bare.hexframes))
        assert launches == 2, f"{launches} tone_ratios launches for a decode with one retry"
        seg = engine.decode_waveform(pcm, fs, device=DEV, wire="int4", mode="segmented")
        assert seg.status == 2 and seg.wire in ("int4", "int8"), (seg.status, seg.wire)
        log(f"[9e] forced retry, {name}: decode_waveform(wire=\"int4\", lossy_retry=False) "
            f"comes back wire int4, status {bare.status}, {len(bare.hexframes)} frames "
            f"(degenerate); with lossy_retry=True wire int8, status 2, {len(res.hexframes)} "
            f"frames, serial = truth; launches {counts_text(counts)} (the int4 decode and "
            f"its int8 retry); mode=\"segmented\" on the same drop comes back wire {seg.wire}, "
            f"{len(seg.hexframes)} frames (its retry decodes again segmented at int8)")
        return launches
    raise AssertionError("no candidate drop collapsed at the int4 wire on the card")


def _wire_cli(tmp: str, drops: dict, want) -> None:
    """Item 5: ``--wire int4`` through the CLI against the in-process decode
    (``"auto"`` mode: the segmented engine at 600 s)."""
    from axctdprocessor_tpu_torch.utils.config import resolve_settings
    from axctdprocessor_tpu_torch.utils.report import write_report

    wav = drops["wav"]
    out = os.path.join(tmp, "report_int4.txt")
    subprocess.run([sys.executable, "-m", "axctdprocessor_tpu_torch.cli", "-i", wav, "-o", out,
                    "--wire", "int4", "--quiet"], cwd=ROOT, check=True, timeout=600)
    settings = {"triggerrange": [30, -1], "minR400": 2.0, "mindR7500": 1.5, "deadfreq": 3000.0,
                "pointsperloop": 100000, "mark_space_freqs": [400.0, 800.0],
                "use_bandpass": False}
    ref = os.path.join(tmp, "report_int4_want.txt")
    write_report(ref, want, wav, [0, -1], settings, resolve_settings(settings))
    assert open(out, "rb").read() == open(ref, "rb").read(), "CLI --wire int4 report differs"
    log(f"[9e] CLI subprocess with --wire int4 on the 600 s WAV: report bytes equal to "
        f"write_report of the in-process segmented decode at int4 "
        f"({open(out).read().count(chr(10))} lines)")


def phase9f_sosfilt(drops: dict) -> None:
    """The parallel (log-step scan) form of the SOS cascade on the card, on
    one second of the bench drop in float64: against the FFT form beyond
    the start-up transient, and against its own CPU run.  A check that the
    function runs and is right on the card; no decode path calls it."""
    from axctdprocessor_tpu_torch.ops import iir
    from axctdprocessor_tpu_torch.utils.wavio import read_wav_raw16

    raw, fs = read_wav_raw16(drops["wav"])
    x = raw[40 * fs: 41 * fs].astype(np.float64) / 32768.0
    sos = iir.design_sos(float(fs))
    card = torch.from_numpy(x).to(DEV)
    scan = iir.sosfilt(sos, card)
    via_fft = iir.sosfilt_fft(sos, card)
    assert scan.device.type == via_fft.device.type == torch.device(DEV).type
    np.testing.assert_allclose(scan.cpu().numpy()[3000:], via_fft.cpu().numpy()[3000:],
                               rtol=1e-6, atol=1e-8)
    on_cpu = iir.sosfilt(sos, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(scan.cpu().numpy(), on_cpu, rtol=1e-9, atol=1e-12)
    err = float(np.max(np.abs(scan.cpu().numpy()[3000:] - via_fft.cpu().numpy()[3000:])))
    log(f"[9f] iir.sosfilt (2x2 affine recurrence as a log-step scan, float64) on the card, "
        f"{len(x)} samples of the 600 s drop: equal to iir.sosfilt_fft beyond sample 3000 within "
        f"rtol 1e-6, atol 1e-8 (max abs difference {err:.3g}) and to its CPU run within rtol "
        f"1e-9, atol 1e-12")


def phase9e_wires(tmp: str, drops: dict) -> dict:
    """The lossy-wire paths on the card: int8, noise-shaped int4 and the int8
    retry through every entry point that takes ``wire=``.  A wire that fails
    a gate fails the run; nothing falls back to int16 or to the CPU."""
    from axctdprocessor_tpu_torch.utils.wavio import read_wav_raw16

    raw, fs = read_wav_raw16(drops["wav"])
    _wire_tensors(raw, drops["batch"])
    kept = _wire_long_drop(drops, raw, fs)
    retried = _wire_rows(tmp, drops)
    launches = _wire_forced_retry(drops, retried)
    _wire_cli(tmp, drops, kept["segmented", "int4"])
    return dict(retry_launches=launches, rows_retried=len(retried))


CORPUS_FULL = 1000  # BASELINE.md's archive configuration, "1000-drop corpus"
CORPUS_CUT = 200    # where the disk does not hold it: every spec and corrupt kind still
HIGH_RATE_PATH = "decode_batch 8 x 60 s at 88.2 kHz"


def _corpus_files(where: str) -> tuple[int, str]:
    """How many files the corpus phase builds in `where`, and why: the full
    1,000 where the free disk holds twice its expected size, else 200."""
    from axctdprocessor_tpu_torch.tools import corpus_1000 as tool

    weights = sum(w for _, _, w in tool.SPECS)
    per_drop = sum(w * 2 * dur * fs for dur, fs, w in tool.SPECS) / weights
    need = per_drop * (CORPUS_FULL - tool.N_CORRUPT)
    usage = shutil.disk_usage(where)
    text = (f"disk at the corpus: {usage} (free {usage.free / 1e9:.1f} GB); the "
            f"{CORPUS_FULL}-file corpus is about {need / 1e9:.2f} GB of int16")
    if usage.free >= 2 * need:
        return CORPUS_FULL, text + ": the full corpus"
    return CORPUS_CUT, text + f": under twice that free, so {CORPUS_CUT} files"


class _Checker(_Standin):
    """Calls the wrapper, then holds the call against its plain version on
    the same arguments (floats within rtol = atol = 2e-4 with equal NaN
    positions, integers bit for bit) and each row of a batched call against
    the wrapper's 1-D call on that row, bit for bit; keeps nothing of the
    call."""

    def __init__(self, name: str, fn, plain, stats: dict):
        self.name, self.fn, self.plain, self.stats = name, fn, plain, stats

    def _row(self, args, kwargs, r):
        if self.name == "probe_at":
            return self.fn(args[0][r], args[1][r], *args[2:], **kwargs)
        return self.fn(args[0][r], *args[1:], **kwargs)

    def __call__(self, *args, **kwargs):
        got = self.fn(*args, **kwargs)
        want = self.plain(*args, **kwargs)
        st = self.stats.setdefault(self.name, dict(calls=0, rows=0, max_abs_err=0.0))
        outs = list(got) if isinstance(got, tuple) else [got]
        wants = list(want) if isinstance(want, tuple) else [want]
        if outs[0].is_floating_point():
            st["max_abs_err"] = max(st["max_abs_err"], _max_err(outs, wants, self.name))
        else:
            assert all(torch.equal(g, w) for g, w in zip(outs, wants)), self.name
        if args[0].dim() == 2:
            for r in range(args[0].shape[0]):
                one = self._row(args, kwargs, r)
                one = list(one) if isinstance(one, tuple) else [one]
                for g, o in zip(outs, one):
                    assert torch.equal(torch.nan_to_num(g[r], nan=7.0),
                                       torch.nan_to_num(o, nan=7.0)), (self.name, r)
            st["rows"] += args[0].shape[0]
        st["calls"] += 1
        return got


@contextlib.contextmanager
def _checked_kernels(stats: dict):
    """Every call of ``tone_ratios``, ``probe_at``, ``chain_walk_segments`` and
    ``chain_walk_frames`` (through their wrappers) checked as it is made."""
    from axctdprocessor_tpu_torch.ops import chain, goertzel, tonepower

    where = [(tonepower, "tone_ratios", "tone_ratios", tonepower.tone_ratios_reference),
             (goertzel, "probe_at", "probe_at", goertzel.tone_power_at),
             (chain, "chain_enumerate_strided", "chain_walk_segments",
              chain.chain_enumerate_strided_reference),
             (chain, "chain_enumerate_frames", "chain_walk_frames",
              chain.chain_enumerate_reference)]
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in where]
    for (mod, attr, name, plain), (_, _, fn) in zip(where, originals):
        setattr(mod, attr, _Checker(name, fn, plain, stats))
    try:
        with _eager_programs():
            yield stats
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def _counted_dispatch(rows: list):
    """``parallel.archive``'s ``dispatch_batch`` wrapped to note in `rows` the
    rows of each batch it queues; restored on exit."""
    from axctdprocessor_tpu_torch.parallel import archive

    real = archive.dispatch_batch

    def counted(pcms, *args, **kwargs):
        rows.append(len(pcms))
        return real(pcms, *args, **kwargs)

    archive.dispatch_batch = counted
    try:
        yield rows
    finally:
        archive.dispatch_batch = real


def phase9g_corpus(tmp: str) -> dict:
    """The archive at the BASELINE's scale: ``tools/corpus_1000.py``'s corpus
    (1,000 files of mixed length and rate, 5 of them corrupt; 200 where the
    disk is short) built in a temporary directory, then through
    ``reprocess_corpus(batch_size=8)`` on the card: a fresh timed run held to
    the tool's gates (done + failed == N, exactly the corrupt files failed,
    every done drop at status 2 with its truth's serial, probe code and
    maximum depth and hexframes in the truth > 0.97); the peak device memory
    of a batch of 120 s drops; a second run with every kernel call checked
    against its plain version and each batched row against its 1-D call,
    its reports byte-equal to the first run's; a resume from the manifest
    cut to half its done entries, which must decode exactly the other half.
    Then one batch of 8 rows at 88.2 kHz through ``decode_batch`` at the
    native rate (the streamed table) against the same rows on the CPU, and
    ``probe_at``'s call of that decode timed (its runs' spans exceed the
    staged buffer)."""
    from axctdprocessor_tpu_torch.parallel.archive import reprocess_corpus
    from axctdprocessor_tpu_torch.tools import corpus_1000 as tool
    from axctdprocessor_tpu_torch.utils.profiling import StageTimer

    t_phase = time.perf_counter()
    cdir = os.path.join(tmp, "corpus_1000")
    n, why = _corpus_files(tmp)
    log(f"[9g] {why}")
    t0 = time.perf_counter()
    bases = tool.build_corpus(cdir, n)
    paths = sorted(os.path.join(cdir, f) for f in os.listdir(cdir))
    build_s = time.perf_counter() - t0
    assert len(paths) == n, (len(paths), n)
    seconds = tool.drop_seconds(paths)
    truths = tool.truths_of(paths, seconds, bases)
    nbytes = sum(os.path.getsize(p) for p in paths)
    kinds = {}
    for name in seconds:
        key = f"{round(seconds[name])} s at {truths[name]['spec'].fs / 1e3:g} kHz"
        kinds[key] = kinds.get(key, 0) + 1
    log(f"[9g] built {n} files ({nbytes / 1e9:.2f} GB) with tools/corpus_1000.py in "
        f"{build_s:.1f} s: {dict(sorted(kinds.items()))} + {tool.N_CORRUPT} corrupt")

    out1 = os.path.join(tmp, "corpus_out")
    timer = StageTimer()
    batch_rows = []
    zero_counts()
    with _counted_dispatch(batch_rows):
        t0 = time.perf_counter()
        manifest = reprocess_corpus(paths, out1, batch_size=8, device="cuda", timer=timer)
        wall = time.perf_counter() - t0
    counts = read_counts(f"archive corpus of {n}")
    files = manifest["files"]
    failed = sorted(k for k, v in files.items() if v["status"] == "failed")
    done = sorted(k for k, v in files.items() if v["status"] == "done")
    assert len(done) + len(failed) == n, (len(done), len(failed), n)
    assert failed == sorted(tool.CORRUPT), failed
    held = tool.check_against_truth(manifest, truths)
    assert held["held_to_truth"] == n - tool.N_CORRUPT, held
    n_88 = sum(truths[k]["spec"].fs == 88200 for k in done)
    audio = sum(seconds[k] for k in done)
    n_batches = len(batch_rows)
    stages = {k: round(v, 4) for k, v in timer.totals.items()}
    per_batch = {k: round(v / n_batches, 2) for k, v in counts.items()}
    log(f"[9g] reprocess_corpus(batch_size=8, device=\"cuda\"), fresh: {len(done)} done, "
        f"{len(failed)} failed (exactly the corrupt files: {failed}); every done drop status 2 "
        f"with its truth's serial, probe code and max depth, hexframes in the truth >= "
        f"{held['lowest_in_truth']:.4f} (gate > {tool.IN_TRUTH}); {n_88} of them 88.2 kHz "
        f"(read through the host's decimation by 2, decoded as float rows at 44.1 kHz)")
    log(f"[9g] wall {wall:.3f} s, {len(done) / wall:.2f} drops/s, {audio:.0f} s of audio, "
        f"realtime factor {audio / wall:.1f}x; stage times (s) {stages}; {n_batches} batches "
        f"of {min(batch_rows)}-{max(batch_rows)} rows; launches {counts_text(counts)}, per "
        f"batch {per_batch}")

    long = [p for p in paths if os.path.basename(p) in seconds
            and round(seconds[os.path.basename(p)]) == 120][:8]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reprocess_corpus(long, os.path.join(tmp, "corpus_120"), batch_size=8, device="cuda")
    peak_120 = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[9g] peak device memory of a batch of {len(long)} drops of 120 s "
        f"(reprocess_corpus alone): {peak_120:.3f} GiB")

    stats = {}
    out2 = os.path.join(tmp, "corpus_checked")
    t0 = time.perf_counter()
    with _checked_kernels(stats):
        checked = reprocess_corpus(paths, out2, batch_size=8, device="cuda")
    checked_s = time.perf_counter() - t0
    assert {k: v["status"] for k, v in checked["files"].items()} == \
        {k: v["status"] for k, v in files.items()}
    for name in done:
        txt = name[:-4] + ".txt"
        assert open(os.path.join(out2, txt), "rb").read() == \
            open(os.path.join(out1, txt), "rb").read(), name
    for name in ("tone_ratios", "probe_at", "chain_walk_segments", "chain_walk_frames"):
        assert stats.get(name, {}).get("calls", 0) >= n_batches, (name, stats.get(name))
    log(f"[9g] a second run with every kernel call checked as it was made ({checked_s:.1f} s): "
        f"{stats}: each within rtol = atol = {RTOL} of its plain version (integers bit for "
        f"bit), each row of a batched call bit-equal to its 1-D call; every report byte-equal "
        f"to the fresh run's")

    out3 = os.path.join(tmp, "corpus_resume")
    os.makedirs(out3)
    keep = set(done[::2])
    with open(os.path.join(out3, "manifest.json"), "w") as f:
        json.dump({"files": {k: files[k] for k in keep}}, f)
    resumed_rows = []
    rtimer = StageTimer()
    zero_counts()
    with _counted_dispatch(resumed_rows):
        t0 = time.perf_counter()
        m3 = reprocess_corpus(paths, out3, batch_size=8, device="cuda", resume=True,
                              timer=rtimer)
        rwall = time.perf_counter() - t0
    read_counts(f"archive corpus of {n}, resumed")
    other = set(done) - keep
    assert sum(resumed_rows) == len(other), (sum(resumed_rows), len(other))
    assert all(m3["files"][k]["finished_at"] == files[k]["finished_at"] for k in keep)
    redone = {k for k, v in m3["files"].items() if v["status"] == "done" and k not in keep}
    assert redone == other, (len(redone), len(other))
    assert sorted(k for k, v in m3["files"].items() if v["status"] == "failed") == failed
    for name in other:
        txt = name[:-4] + ".txt"
        assert open(os.path.join(out3, txt), "rb").read() == \
            open(os.path.join(out1, txt), "rb").read(), name
    log(f"[9g] resume from the manifest cut to {len(keep)} of its {len(done)} done entries: "
        f"decoded exactly the other {len(other)} ({sum(resumed_rows)} rows in "
        f"{len(resumed_rows)} batches, the corrupt files failed again) in {rwall:.3f} s, their "
        f"reports byte-equal to the fresh run's; the kept entries untouched")
    shutil.rmtree(cdir)

    log(f"[9g] program cache after the corpus runs: {cache_text()}")
    hr = _high_rate_batch(bases)
    log(f"[9g] phase time {time.perf_counter() - t_phase:.0f} s (build {build_s:.0f} s)")
    return dict(n=n, wall=wall, launches=counts, batches=n_batches, hr=hr, peak_120=peak_120)


# ---------------------------------------------------------------------------
# phase 9h: the cached programs (models/programs.py)
# ---------------------------------------------------------------------------

def _cache_held() -> dict:
    """What the program cache holds on the card: its programs, how many are
    captured, the bytes of their graphs' private memory pools (the segments
    of ``torch.cuda.memory_snapshot()`` under the pools' ids, and the sum of
    the ``pool_bytes`` each program read at its capture and its static
    inputs, which the cache's bound counts) against the bound, and the bytes
    of their static inputs and tables.  Fails if the programs hold more than
    the bound."""
    from axctdprocessor_tpu_torch.models import programs

    progs = programs.programs()
    by_pool = {tuple(p.graph.pool()): 0 for p in progs if p.graph is not None}
    segs = [seg for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) in by_pool]
    for seg in segs:
        by_pool[tuple(seg["segment_pool_id"])] += seg["total_size"]
    static = [t for p in progs
              for t in (*p.inputs, *(p.module.buffers() if p.module is not None else ()))]
    each = [f"{p.key[0]} {str(p.inputs[0].dtype).replace('torch.', '')} "
            f"{tuple(p.inputs[0].shape)} {by_pool[tuple(p.graph.pool())] / 2 ** 30:.3f}"
            for p in progs if p.graph is not None]
    held = programs.held_bytes("cuda:0")
    budget = programs.pool_budget(torch.device("cuda", 0))
    assert held <= budget, f"the cached programs hold {held} bytes, over the bound {budget}"
    return dict(programs=len(progs), captured=len(by_pool), pool_segments=len(segs),
                pool_gib=sum(by_pool.values()) / 2 ** 30, each=each,
                held_gib=held / 2 ** 30, budget_gib=budget / 2 ** 30,
                static_gib=sum(t.numel() * t.element_size() for t in static) / 2 ** 30)


def cache_text() -> str:
    h = _cache_held()
    pools = (f"{h['pool_gib']:.3f} GiB in their graphs' private pools ({h['pool_segments']} "
             f"segments; by kind and first input, GiB: {'; '.join(h['each'])})"
             if h["pool_segments"] or not h["captured"] else
             "their graphs' pools not measured (no segment under their ids)")
    return (f"{h['programs']} programs ({h['captured']} captured): {pools}; the pools as read "
            f"at capture and the static inputs (what the bound counts) {h['held_gib']:.3f} GiB "
            f"of the bound {h['budget_gib']:.3f} GiB, "
            f"{h['static_gib']:.3f} GiB of static inputs and tables; the card's reserved memory "
            f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB")


@contextlib.contextmanager
def _packed_results():
    """Every packed vector the host finish is handed while the block runs
    (``engine.finish_result``), as numpy arrays, in order."""
    from axctdprocessor_tpu_torch.models import engine

    got, real = [], engine.finish_result

    def finish(out, *args, **kwargs):
        got.append(np.array(out))
        return real(out, *args, **kwargs)

    engine.finish_result = finish
    try:
        yield got
    finally:
        engine.finish_result = real


def _int16_drop(duration: float, seed: int) -> np.ndarray:
    from axctdprocessor_tpu_torch.models import simulator

    pcm, _ = simulator.synthesize(simulator.SimSpec(duration=duration, profile_start=33.0,
                                                    seed=seed))
    return np.round(pcm * (28000 / np.max(np.abs(pcm)))).astype(np.int16)


# the monolithic shapes' three drops (duration s, simulator seed): different
# lengths inside one 15 s bucket, different seeds (600 s: the bench drop first)
PROGRAM_DROPS = {"60 s": ((46.0, 21), (53.0, 22), (60.0, 23)),
                 "300 s": ((287.0, 11), (293.0, 12), (300.0, 13)),
                 "600 s": ((600.0, 11), (589.0, 12), (595.0, 13))}
PROGRAM_WIRES = ("int16", "int8")


def _newest_program(calls: int):
    from axctdprocessor_tpu_torch.models import programs

    program = programs.programs()[-1]
    assert program.calls == calls and program.graph is not None, (program.calls, program.graph)
    return program


def _program_steps(label: str, fns: list, first_differs: bool = False) -> tuple[list, list]:
    """Each of `fns` once, in order, through a program of one shape that is
    new (the first call eager, the second captured, the rest replayed):
    their walls, and every kernel's launches per call, which must equal the
    first (eager) call's; with `first_differs`, one more call made eagerly
    (``_eager_programs``) after them (the prestaged module computes its
    shared zero segment once, in its first forward)."""
    walls, counts = [], []
    for i, fn in enumerate(fns + ([fns[-1]] if first_differs else [])):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _eager_programs() if first_differs and i == len(fns) else contextlib.nullcontext():
            fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append(read_counts(f"program {label}, call {i + 1}"))
    same = counts[1:] if first_differs else counts
    assert all(c == same[-1] for c in same), (label, counts)
    return walls[: len(fns)], same[-1]


def _program_monolithic(label: str, raws: list, fs, wire: str) -> dict:
    """Three drops of one bucket and the first again through
    ``decode_waveform(mode="monolithic")``: every packed vector bit for bit
    the eager module's forward on the same static input."""
    from axctdprocessor_tpu_torch.models import engine
    from axctdprocessor_tpu_torch.ops import wire as wire_ops

    seq = raws + raws[:1]
    with _packed_results() as packed:
        walls, counts = _program_steps(f"monolithic {label} {wire}", [
            lambda raw=raw: engine.decode_waveform(raw, fs, device="cuda", mode="monolithic",
                                                   wire=wire, lossy_retry=False)
            for raw in seq])
    program = _newest_program(len(seq))
    n = program.inputs[0].shape[0]
    for raw, got in zip(seq, packed):
        enc = wire_ops.encode(raw, wire)
        x = torch.from_numpy(np.concatenate([enc, np.zeros(n - len(enc), enc.dtype)])).cuda()
        with torch.inference_mode():
            want = program.module(x, torch.full((), len(raw), dtype=torch.int64, device="cuda"))
        assert np.array_equal(got, want.cpu().numpy()), (label, wire)
        assert engine.unpack_result(got)["scal_i"][1] >= 0, (label, wire)  # a profile found
    assert np.array_equal(packed[-1], packed[0])
    return dict(walls=walls, counts=counts)


def _variant_batches(rows: np.ndarray, fs) -> list:
    """Three batches of `rows`' shape: the rows, and the rows in two
    shuffled orders (rng seeds 1, 2), each with its own true lengths (up to
    5 s short of the width, zeros after)."""
    out = []
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        sub = (rows if seed == 0 else rows[rng.permutation(len(rows))]).copy()
        lengths = rows.shape[1] - rng.integers(0, int(5 * fs), len(rows))
        for r, n in enumerate(lengths):
            sub[r, n:] = 0  # zero-padded past the true length, as pad_batch pads
        out.append((sub, lengths))
    return out


def _program_batches(label: str, batches: list, fs, wire: str) -> dict:
    """Three batches of one shape through ``dispatch_batch`` in a row, then
    two interleaved (dispatch k, dispatch k+1, finish k, finish k+1): every
    packed matrix bit for bit the eager module's forward on the same rows,
    every row at status 2."""
    from axctdprocessor_tpu_torch.parallel import batch

    outs = []

    def one(rows, lengths):
        out, ctx = batch.dispatch_batch(rows, fs, device="cuda", lengths=lengths, wire=wire)
        assert all(r.status == 2 for r in batch.finish_dispatched(out, ctx)), label
        outs.append(out)

    walls, counts = _program_steps(f"{label} {wire}", [
        lambda b=b: one(*b) for b in batches])
    k, k1 = (batch.dispatch_batch(rows, fs, device="cuda", lengths=lengths, wire=wire)
             for rows, lengths in batches[1:])
    interleaved = [k[0], k1[0]]
    for out, ctx in (k, k1):
        assert all(r.status == 2 for r in batch.finish_dispatched(out, ctx)), label
    program = _newest_program(len(batches) + 2)
    plan = batch.BatchPlan(batches[0][0].dtype, batches[0][0].shape[1], fs, None, wire, "cuda")
    for (rows, lengths), out in zip(batches + batches[1:], outs + interleaved):
        with torch.inference_mode():
            want = program.module(torch.from_numpy(plan.encode(rows)).cuda(),
                                  torch.from_numpy(lengths.astype(np.int64)).cuda())
        assert torch.equal(out, want), (label, wire)
    return dict(walls=walls, counts=counts)


def _program_prestaged(raws: list, fs) -> dict:
    """Three 600 s drops staged with ``fused=True`` (int8, int16, int8), each
    its own program: three ``dispatch()`` calls in a row (eager, captured,
    replayed), then 8 queued: every output bit for bit the eager module's
    forward on the staged stack, 8 distinct tensors."""
    from axctdprocessor_tpu_torch.models import segmented

    walls = []
    for i, (raw, wire) in enumerate(zip(raws, ("int8", "int16", "int8"))):
        st = segmented.prestage_waveform(raw, fs, device="cuda", wire=wire, fused=True)
        outs = []
        w, counts = _program_steps(f"prestaged 600 s {wire} drop {i + 1}", [
            lambda: outs.append(st.dispatch()) or st.finish(outs[-1]) for _ in range(3)],
            first_differs=True)
        walls.append(w)
        queued = [st.dispatch() for _ in range(8)]
        assert st.program.calls == 12 and st.program.graph is not None
        assert len({o.data_ptr() for o in queued}) == 8
        p = st.plan
        with torch.inference_mode():
            want = p.model(st.ext_all, p.n_seg, p.dc, p.peak, p.n_raw, p.nv_dec, p.dims)
        assert all(torch.equal(o, want) for o in outs + queued), (i, wire)
        assert st.finish(queued[-1]).status == 2
        del st, outs, queued
    return dict(walls=walls, counts=counts)


# the 600 s drop's bucket (28 segments) holds drops of 25-28 segments: a
# longer one (655 s: 28) and then a shorter one (575 s: 25), whose assemble
# replays over rows 25-27 that still hold the longer drop's segments
SEGMENTED_DROPS = ((655.0, 14), (575.0, 15))


def _eager_drop(raw, fs, wire: str = "auto", group: int = 4):
    """The group program's own module, its whole eager forward
    (``SegmentedDecoder.forward``: every segment in one pass, then the
    assemble) over a drop's extensions as the plan encodes them."""
    from axctdprocessor_tpu_torch.models import segmented
    from axctdprocessor_tpu_torch.utils.profiling import StageTimer

    p = segmented._plan_waveform(raw, fs, None, wire, StageTimer(), "cuda", group)
    exts = np.concatenate([segmented._chunk_host(p, j) for j in range(p.n_chunk)])
    with torch.inference_mode():
        return p.model(torch.from_numpy(exts).cuda()[None], p.n_seg, p.dc, p.peak, p.n_raw,
                       p.nv_dec, p.dims).cpu().numpy()


def _segment_programs_captured(raw, fs, wire: str = "auto", group: int = 4) -> None:
    from axctdprocessor_tpu_torch.models import segmented
    from axctdprocessor_tpu_torch.utils.profiling import StageTimer

    p = segmented._plan_waveform(raw, fs, None, wire, StageTimer(), "cuda", group)
    assert all(prog.graph is not None for prog in p.group_programs()), "not captured"


def _program_segmented(raw600, fs) -> dict:
    """The 600 s drop, then a longer and a shorter drop of its bucket, through
    ``decode_waveform_segmented`` (the group program: eager at its first
    group, captured at its second, replayed after; the bucket's assemble
    program: eager, captured, replayed): every packed vector bit for bit the
    module's eager forward on the same extensions."""
    from axctdprocessor_tpu_torch.models import engine, segmented

    raws = [raw600] + [_int16_drop(d, s) for d, s in SEGMENTED_DROPS]
    with _packed_results() as packed:
        # the first decode builds the bucket's assemble program, whose module
        # makes its zero segment once
        walls, counts = _program_steps("segmented 600 s bucket", [
            lambda raw=raw: segmented.decode_waveform_segmented(raw, fs, device="cuda",
                                                                lossy_retry=False)
            for raw in raws], first_differs=True)
    _segment_programs_captured(raw600, fs)
    for raw, got in zip(raws, packed):
        assert np.array_equal(got, _eager_drop(raw, fs)), len(raw)
        assert engine.unpack_result(got)["scal_i"][1] >= 0, len(raw)  # a profile found
    return dict(walls=walls, counts=counts)


def _program_prestaged_groups(raw, fs) -> dict:
    """The 600 s drop prestaged group by group (int8): three ``dispatch()``
    calls in a row, then 8 queued: every output bit for bit the module's
    eager forward, 8 distinct tensors."""
    from axctdprocessor_tpu_torch.models import segmented

    st = segmented.prestage_waveform(raw, fs, device="cuda")
    outs = []
    walls, counts = _program_steps("prestaged 600 s groups int8", [
        lambda: outs.append(st.dispatch()) or st.finish(outs[-1]) for _ in range(3)],
        first_differs=True)
    queued = [st.dispatch() for _ in range(8)]
    assert len({o.data_ptr() for o in queued}) == 8
    _segment_programs_captured(raw, fs, wire="int8")
    want = _eager_drop(raw, fs, wire="int8")
    assert all(np.array_equal(o.cpu().numpy(), want) for o in outs + queued)
    assert st.finish(queued[-1]).status == 2
    return dict(walls=walls, counts=counts)


def _stream_fed(pcm, fs, snapshots: bool) -> tuple:
    """A stream pinned to the drop's bucket (``max_duration``), fed in 1 s
    blocks, with a ``results()`` snapshot each time a segment lands if
    `snapshots`: (the decoder, the segment count at each snapshot)."""
    from axctdprocessor_tpu_torch.models.stream_device import DeviceStreamDecoder

    dec = DeviceStreamDecoder(fs, max_duration=len(pcm) / fs, device="cuda")
    snaps = []
    for i in range(0, len(pcm), int(fs)):
        before = dec._next_k
        if dec.feed(pcm[i: i + int(fs)]) > before and snapshots:
            dec.results()
            snaps.append(dec._next_k)
    return dec, snaps


def _program_stream(pcm, fs) -> dict:
    """A stream of the 600 s drop pinned to its bucket: its constructor
    captures the one-row segment program and the bucket's assemble program;
    then no capture while it is fed in 1 s blocks with a snapshot at each new
    segment and finalized; every snapshot and ``finalize()`` bit for bit the
    module's eager assemble of the same segments, each decoded alone by the
    module as the stream queues it."""
    from axctdprocessor_tpu_torch.models import engine, programs, segmented
    from axctdprocessor_tpu_torch.models.stream_device import BIG_N

    captures = []
    real = programs.Program.capture

    def capture(self):
        captures.append(self.key[0])
        return real(self)

    programs.Program.capture = capture
    try:
        t0 = time.perf_counter()
        with _packed_results() as packed:
            dec, snaps = _stream_fed(pcm, fs, snapshots=True)
            ctor = captures[:]
            del captures[:]
            final = dec.finalize()
        wall = time.perf_counter() - t0
    finally:
        programs.Program.capture = real
    assert not captures, f"captures after the constructor: {captures}"
    assert final.status == 2 and len(snaps) == dec._next_k - 1, (final.status, snaps)
    model = dec._model
    seg_len, n = model.seg_len, len(pcm)
    dims = engine.EngineDims.for_waveform(dec._pin_bucket * seg_len, float(fs), model.bitrate,
                                          model.npcm)
    outs = []
    with torch.inference_mode():
        for k in range(dec._next_k):
            lo = k * seg_len - segmented.LEFT_HALO
            ext = np.zeros((1, model.in_len), np.float32)
            src = pcm[max(lo, 0): lo + model.in_len]
            ext[0, max(-lo, 0): max(-lo, 0) + len(src)] = src
            last = k == dec._next_k - 1
            outs.append(model.segment(torch.from_numpy(ext).cuda(),
                                      torch.full((1,), k * seg_len, device="cuda"),
                                      torch.zeros((), device="cuda"),
                                      torch.ones((), device="cuda"), n if last else BIG_N))
        for got, (k, nv) in zip(packed, [(k, k * seg_len) for k in snaps] + [(len(outs), n)]):
            want = model.assemble(outs[:k], torch.tensor(nv, device="cuda"), dims)
            assert np.array_equal(got, want.cpu().numpy()), k
    return dict(snapshots=len(snaps), constructor_captures=ctor, wall=wall)


def _program_pipeline(rows: np.ndarray, fs) -> dict:
    """The 64 rows through ``decode_batches_pipelined`` as batches of 8 and
    as one batch of 64, each in three row orders (the rows, two
    permutations): every batch's packed matrix bit for bit the stage-1 and
    back-half modules' eager forward on the same rows; one tone-ratio launch
    and three bit-edge walk launches per batch."""
    from axctdprocessor_tpu_torch.parallel import batch, pipeline

    orders = [np.arange(len(rows))] + [np.random.default_rng(seed).permutation(len(rows))
                                       for seed in (1, 2)]
    out = {}
    for size in (8, 64):
        batches = [(rows[o][i: i + size], None) for o in orders
                   for i in range(0, len(rows), size)]
        zero_counts()
        t0 = time.perf_counter()
        with _packed_results() as packed:
            res = pipeline.decode_batches_pipelined(batches, fs, device="cuda")
        wall = time.perf_counter() - t0
        counts = read_counts(f"pipeline programs {len(batches)} x {size}")
        assert counts["tone_ratios"] == len(batches), counts
        assert counts["chain_walk_segments"] == 3 * len(batches), counts
        assert all(r.status == 2 for b in res for r in b)
        plan = batch.BatchPlan(rows.dtype, rows.shape[1], fs, None, "auto", "cuda")
        x = torch.from_numpy(rows[:size]).cuda()
        front = plan.stage1_program(x)
        with torch.inference_mode():
            back = plan.back_half_program(front.output)
        assert front.graph is not None and back.graph is not None
        model = front.module
        for b, (sub, _) in enumerate(batches):
            xb = torch.from_numpy(sub).cuda()
            nv = torch.full((size,), sub.shape[1], dtype=torch.int64, device="cuda")
            with torch.inference_mode():
                want = model.back_half(model.stage1(xb, nv), nv).cpu().numpy()
            assert np.array_equal(np.stack(packed[b * size: (b + 1) * size]), want), (size, b)
        out[f"{size} rows"] = dict(batches=len(batches), wall=wall, counts=counts)
    return out


def _turns(fns: dict, runs: int = 5) -> dict:
    """Warm walls of each path eager (``_eager_programs``: the module's
    forward over the program's static buffers) and through its program, in
    turns, `runs` of each: {path: (eager walls, program walls)}."""
    out = {name: ([], []) for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            with _eager_programs():
                out[name][0].extend(_walls(fn, 1))
            out[name][1].extend(_walls(fn, 1))
    return out


def phase9h_programs(drops: dict, seg: dict) -> dict:
    """The cached programs against the eager module, bit for bit, on every
    path they serve; their counts, syncs and walls.  Shapes: one drop of 60
    s, one of 300 s and the 600 s drop forced monolithic (at int16 and int8:
    three drops of one bucket with different seeds, then the first again),
    8 and 64 rows of 60 s (three batches, then two interleaved), the 600 s
    drop prestaged with ``fused=True`` (three drops, each its own program);
    the segmented engine's group and assemble programs (the 600 s drop
    streamed, then a longer and a shorter drop of its bucket; prestaged group
    by group; a pinned stream with a snapshot at each segment) and the
    pipeline's stage-1 and back-half programs (batches of 8 and of 64 rows,
    three row orders).  Then host syncs of a replayed decode, warm walls
    eager against program in turns (medians of 5), the capture decode's
    wall, the cuFFT plan cache and the memory the program cache holds."""
    from axctdprocessor_tpu_torch.models import engine, programs, segmented
    from axctdprocessor_tpu_torch.parallel import batch, pipeline
    from axctdprocessor_tpu_torch.utils.wavio import read_wav

    t_phase = time.perf_counter()
    programs.clear()
    fs = seg["fs"]
    steps = {}
    raws = {}
    for label, specs in PROGRAM_DROPS.items():
        raws[label] = [seg["raw"] if (d, s) == (600.0, 11) else _int16_drop(d, s)
                       for d, s in specs]
        for wire in PROGRAM_WIRES:
            steps[f"monolithic {label} {wire}"] = _program_monolithic(label, raws[label], fs,
                                                                     wire)
    rows, bfs = drops["batch"], drops["batch_fs"]
    for label, sub in (("decode_batch 8 x 60 s", rows[:8]), ("decode_batch 64 x 60 s", rows)):
        for wire in PROGRAM_WIRES:
            steps[f"{label} {wire}"] = _program_batches(label, _variant_batches(sub, bfs), bfs,
                                                        wire)
    steps["prestaged 600 s fused"] = _program_prestaged(raws["600 s"], fs)
    steps["segmented 600 s bucket"] = _program_segmented(seg["raw"], fs)
    steps["prestaged 600 s groups int8"] = _program_prestaged_groups(seg["raw"], fs)
    for name, st in steps.items():
        walls = st["walls"] if name != "prestaged 600 s fused" else st["walls"][0]
        log(f"[9h] {name}: every output bit for bit the eager module's forward; walls of the "
            f"calls in order (eager, capture, replays) {[round(w, 4) for w in walls]} s; "
            f"launches a call {counts_text(st['counts'])}")
    pcm600 = read_wav(drops["wav"])[0]
    st = _program_stream(pcm600, fs)
    log(f"[9h] stream of the 600 s drop pinned to its bucket: its constructor captured "
        f"{st['constructor_captures']}, nothing captured after it; {st['snapshots']} "
        f"snapshots and finalize() bit for bit the module's eager assemble of the same "
        f"segments; {st['wall']:.3f} s in all")
    for label, pp in _program_pipeline(rows, bfs).items():
        log(f"[9h] pipeline, batches of {label}: {pp['batches']} batches (three row orders) "
            f"through the stage-1 and back-half programs, every packed matrix bit for bit "
            f"the modules' eager forward; {pp['wall']:.3f} s; launches "
            f"{counts_text(pp['counts'])}")
    raw600 = seg["raw"]
    staged = segmented.prestage_waveform(raw600, fs, device="cuda", fused=True)
    groups = segmented.prestage_waveform(raw600, fs, device="cuda")
    stream, _ = _stream_fed(pcm600, fs, snapshots=False)
    batches8 = [(sub, None) for sub in np.split(rows, 8)]
    fns = {
        "monolithic 60 s": lambda: engine.decode_waveform(raws["60 s"][2], fs, device="cuda"),
        "monolithic 300 s": lambda: engine.decode_waveform(raws["300 s"][2], fs, device="cuda"),
        "monolithic 600 s": lambda: engine.decode_waveform(raw600, fs, device="cuda",
                                                           mode="monolithic"),
        "decode_batch 8 x 60 s": lambda: batch.decode_batch(rows[:8], bfs, device="cuda"),
        "decode_batch 64 x 60 s": lambda: batch.decode_batch(rows, bfs, device="cuda"),
        "prestaged 600 s fused": staged.decode,
        "segmented 600 s": lambda: segmented.decode_waveform_segmented(raw600, fs,
                                                                       device="cuda"),
        "prestaged 600 s groups": groups.decode,
        "stream snapshot, 600 s (25 segments)": stream.results,
        "pipeline 8 x 8 x 60 s": lambda: pipeline.decode_batches_pipelined(batches8, bfs,
                                                                           device="cuda"),
        "decode_batch 8 x 8 x 60 s": lambda: [batch.decode_batch(sub, bfs, device="cuda")
                                              for sub, _ in batches8],
    }
    syncs = {}
    for name, fn in fns.items():
        fn()
        fn()  # the program of this shape captured
        with count_syncs() as box:
            fn()
        syncs[name] = box["n"]
        # a batch's fetch waits on a CUDA event, which the sync debug mode
        # does not see: one copy per batch; a single drop's fetch synchronizes
        # its stream (``device_wait``) before its copy
        single = name.startswith(("monolithic", "segmented"))
        assert box["n"] <= (8 if "8 x 8" in name else 2 if single else 1), (name, box["n"])
    captures = []
    real_capture = programs.Program.capture
    programs.Program.capture = lambda self: captures.append(self.key) or real_capture(self)
    try:
        turns = _turns(fns)
    finally:
        programs.Program.capture = real_capture
    kinds = collections.Counter(p.key[0] for p in programs.programs() if p.key)
    assert not captures, f"programs captured again in the turns (evicted in use): {captures}"
    log(f"[9h] the turns ran through {sum(kinds.values())} cached programs at once "
        f"({dict(kinds)}; at most {programs.MAX_PROGRAMS} of a kind) and captured none again")
    med = {name: (statistics.median(e), statistics.median(p)) for name, (e, p) in turns.items()}
    for name, (e, p) in med.items():
        log(f"[9h] {name}: warm wall (median of 5, in turns) eager {e:.4f} s, program "
            f"{p:.4f} s, ratio {e / p:.2f}; eager {[round(w, 4) for w in turns[name][0]]}, "
            f"program {[round(w, 4) for w in turns[name][1]]}; host syncs per replayed decode "
            f"{syncs[name]}")
    def queued(k: int = 8) -> float:
        t0 = time.perf_counter()
        outs = [staged.dispatch() for _ in range(k)]
        for o in outs:
            staged.finish(o)
        return (time.perf_counter() - t0) / k

    per = {"eager": [], "program": []}
    for _ in range(3):  # in turns
        with _eager_programs():
            per["eager"].append(queued())
        per["program"].append(queued())
    e, p = med["prestaged 600 s fused"]
    log(f"[9h] 8 queued prestaged fused decodes (8 dispatches, then 8 finishes), per decode, "
        f"median of 3 in turns: eager {statistics.median(per['eager']):.4f} s "
        f"{[round(w, 4) for w in per['eager']]}, program {statistics.median(per['program']):.4f}"
        f" s {[round(w, 4) for w in per['program']]}; one decode: eager {e:.4f} s, program "
        f"{p:.4f} s")
    plans = torch.backends.cuda.cufft_plan_cache[torch.cuda.current_device()]
    log(f"[9h] cuFFT plan cache: {plans.size} plans of at most {plans.max_size}; program "
        f"cache {cache_text()}; phase time {time.perf_counter() - t_phase:.0f} s")
    assert plans.size < plans.max_size, "the cuFFT plan cache is full: a cached graph's plan may go"
    del staged, groups, stream
    return dict(walls={k: v for k, v in med.items()}, syncs=syncs, steps=steps)


def _high_rate_batch(bases: dict) -> dict:
    """8 rows of the corpus's 88.2 kHz base with the corpus's kind of noise
    through ``decode_batch`` on the card at their native rate: the tone
    kernel streams its table; against the same rows on the CPU (hexframes,
    metadata and every integer field of the packed result equal); then the
    share of the runs of ``probe_at``'s call of that decode that its
    geometry for the window stages."""
    from axctdprocessor_tpu_torch.models import engine
    from axctdprocessor_tpu_torch.ops import goertzel
    from axctdprocessor_tpu_torch.ops.kernels import extension
    from axctdprocessor_tpu_torch.parallel import batch

    base, truth = bases[(60.0, 88200)]
    rng = np.random.default_rng(88200)
    rows = np.stack([np.clip(base + rng.integers(-300, 300, len(base)), -32768, 32767)
                     .astype(np.int16) for _ in range(8)])
    calls, path = [], ["88.2 kHz"]
    zero_counts()
    real_probe = goertzel.probe_at
    goertzel.probe_at = _Recorder(real_probe, calls, path)
    try:
        with _eager_programs():
            out, ctx = batch.dispatch_batch(rows, 88200, device="cuda")
            card = out.cpu().numpy()
            got = batch.finish_dispatched(out, ctx)
    finally:
        goertzel.probe_at = real_probe
    counts = read_counts(HIGH_RATE_PATH, high_rate=True)
    assert counts["tone_ratios"] == 1 and counts[STREAMED] == 1, counts
    t0 = time.perf_counter()
    out_c, ctx_c = batch.dispatch_batch(rows, 88200, device="cpu")
    want = batch.finish_dispatched(out_c, ctx_c)
    cpu_s = time.perf_counter() - t0
    moved, in_truth = 0, 1.0
    for r, (g, w) in enumerate(zip(got, want)):
        in_truth = min(in_truth, _gates_60s(g, truth))
        assert g.hexframes == w.hexframes and g.metadata == w.metadata, r
        gu, wu = engine.unpack_result(card[r]), engine.unpack_result(out_c.numpy()[r])
        for key in ("scal_i", "hdr", "hexpack", "edges"):
            assert np.array_equal(gu[key], wu[key]), (r, key)
        moved += int(np.count_nonzero(gu["ratios"] != wu["ratios"]))
    log(f"[9g] {HIGH_RATE_PATH} (int16 rows at the native rate): every row status 2 with the "
        f"truth's serial, probe code and max depth, hexframes in the truth >= {in_truth:.4f}; "
        f"hexframes, metadata and every integer field of the packed result (scal_i, hdr, "
        f"hexpack, edges) equal to decode_batch(device=\"cpu\") of the same rows ({cpu_s:.1f} "
        f"s on the host); ratios (centi-units) that differ: {moved}; launches "
        f"{counts_text(counts)}")
    assert len(calls) == 1, len(calls)
    _, args, _ = calls[0]
    x, starts, window, _ = args
    run, span = extension().probe_geometry(window)
    staged, median_span = _probe_staged_share(x, starts, window, run, span)
    log(f"[9g] probe_at of that decode (x {tuple(x.shape)}, K = {starts.shape[-1]}, window "
        f"{window}): {staged:.3f} of its runs of {run} probes staged in the {span}-float "
        f"buffer (median span {median_span:.0f}; phase 2d times this kind of call)")
    return dict(rows=rows, cpu_s=cpu_s)


def _gates_60s(res, truth) -> float:
    """A 60 s drop's gates (``_gates`` less the 1,000 rows of the 600 s
    drop): status 2, the truth's metadata, no overflow, hexframes in the
    truth > 0.97; returns that share."""
    assert res.status == 2, res.status
    for key in ("serial_no", "probe_code", "max_depth"):
        assert res.metadata[key] == truth[key], (key, res.metadata[key])
    assert res.overflow == 0, res.overflow
    truth_set = set(truth["frame_hex"])
    in_truth = sum(h in truth_set for h in res.hexframes) / len(res.hexframes)
    assert in_truth > 0.97, in_truth
    return in_truth


def _per_path(name: str) -> dict:
    return {path: counts[name] for path, counts in PATH_LAUNCHES.items()}


def _chain_entry(name: str, recs: list) -> dict:
    """One chain kernel's entry of the ``kernels`` line: launches on every
    path, and the numbers of the monolithic 600 s decode's largest call."""
    main_rec = max((r for r in recs if r["shape"].startswith("600 s")),
                   key=lambda r: r["rows"] * r["m"] * r.get("k", 1))
    return {"name": name, "route": "cuda", "source": CHAIN_SOURCE,
            "replaces": CHAIN_REPLACES[name],
            "launches": PATH_LAUNCHES["monolithic 600 s"][name],
            "launches_per_path": _per_path(name), "max_abs_err": 0,
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "device_ms": main_rec["device_ms"], "shape": main_rec["shape"],
            "shapes": [{key: r[key] for key in r} for r in recs]}


def _streamed_entry(k: dict) -> dict:
    """The streamed-table tone kernel's entry of the ``kernels`` line: its
    launches on the 88.2 kHz batch of 8 rows (phase 9g) and every path, and
    its numbers at phase 2's 8 x 60 s case at 88.2 kHz."""
    recs = k["streamed"]
    main_rec = next(r for r in recs if r["rows"] == 8 and r["fs"] == 88200.0)
    return {"name": STREAMED, "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": PATH_LAUNCHES[HIGH_RATE_PATH][STREAMED],
            "launches_per_path": _per_path(STREAMED),
            "max_abs_err": max(max(r["max_abs_err"], r["powers_max_abs_err"]) for r in recs),
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_us"] / 1e3, "bound_by": main_rec["bound_by"],
            "library_ms": None, "dft_core_matmul_ms": main_rec["dft_core_matmul_ms"],
            "device_ms": main_rec["device_ms"], "shape": main_rec["shape"],
            "shapes": [dict(r) for r in recs]}


# the path whose run gives a front-end kernel's ``launches``: the monolithic
# decode for the probe, the segmented one (``"auto"`` at 600 s) for the
# raw powers, which the monolithic decode does not run
FRONTEND_MAIN_PATH = {"probe_at": "monolithic 600 s", "tone_powers": "segmented 600 s"}


def _frontend_entry(name: str, fk: dict) -> dict:
    """A front-end kernel's entry of the ``kernels`` line: launches on every
    path, and the numbers at the first timed shape (the 600 s monolithic
    decode's probe; the 600 s segmented decode's first group of powers)."""
    recs = fk["shapes"][name]
    main_rec = recs[0]
    entry = {"name": name, "route": "cuda", "source": FRONTEND_SOURCE[name],
             "replaces": FRONTEND_REPLACES[name],
             "launches": PATH_LAUNCHES[FRONTEND_MAIN_PATH[name]][name],
             "launches_per_path": _per_path(name), "max_abs_err": fk["max_abs_err"][name],
             "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
             "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
             "library_ms": main_rec["library_ms"], "device_ms": main_rec["device_ms"],
             "shape": main_rec["shape"], "shapes": [dict(r) for r in recs]}
    if name == "probe_at":  # the batch paths' rows above 50 kHz (phase 2d)
        entry["high_rate_shapes"] = [dict(r) for r in fk["high_rate"]]
    return entry


def _chain_walk_entry(rec: dict) -> dict:
    """``chain_walk``'s entry (the general map's walk, on no decode path:
    ``read_counts`` holds its launches to 0 on every path): timed alone on the
    jump tables of the 600 s decode's largest frame-sync table."""
    return {"name": "chain_walk", "route": "cuda", "source": CHAIN_SOURCE,
            "replaces": "axctdprocessor_tpu/ops/chain.py:216-245", "launches": 0,
            "launches_per_path": {path: 0 for path in PATH_LAUNCHES}, "max_abs_err": 0,
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "device_ms": rec["device_ms"],
            "shape": rec["shape"]}


def main() -> int:
    smi, kind = phase0_device()
    phase1_build()
    mark("1 (builds)")
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        drops = phase1_drops(tmp)
        if sys.argv[1:] == ["--only-wires"]:  # a development run: no result lines
            phase9e_wires(tmp, drops)
            phase9f_sosfilt(drops)
            return 3
        if sys.argv[1:] == ["--only-chain"]:  # a development run: no result lines
            phase2b_chain(drops)
            mark("2b")
            return 3
        if sys.argv[1:] == ["--only-corpus"]:  # a development run: no result lines
            _phase2_streamed()
            mark("2 (streamed table)")
            phase9g_corpus(tmp)
            mark("9g")
            return 3
        if sys.argv[1:] == ["--only-programs"]:  # a development run: no result lines
            from axctdprocessor_tpu_torch.utils.wavio import read_wav_raw16

            raw, fs = read_wav_raw16(drops["wav"])
            phase9h_programs(drops, dict(raw=raw, fs=fs))
            mark("9h")
            _profile_programs(dict(raw=raw, fs=fs), drops)
            mark("10 (programs)")
            return 3
        if sys.argv[1:] == ["--only-frontend"]:  # a development run: no result lines
            phase2c_fft(drops)
            mark("2c")
            phase2d_frontend(drops)
            mark("2d")
            phase2e_batched_rows(drops)
            mark("2e")
            return 3
        k = phase2_kernel(drops)
        mark("2")
        ck = phase2b_chain(drops)
        mark("2b")
        phase2c_fft(drops)
        fk = phase2d_frontend(drops)
        phase2e_batched_rows(drops)
        mark("2c-2e")
        mono = phase3_end_to_end(drops)
        phase4_highrate(tmp)
        phase5_cli(tmp, drops["wav"])
        mark("3-5")
        seg = phase6_segmented(drops, mono)
        phase7_prestaged(drops, seg)
        phase8_stream(drops)
        mark("6-8")
        bat = phase9_batch(drops)
        piped = phase9a_pipeline(drops, bat)
        mark("9-9a")
        arch = phase9b_archive(tmp, drops, piped)
        mark("9b")
        phase9c_parity(tmp, drops, mono)
        mark("9c")
        multi = phase9d_multi_device(drops, mono, bat, piped)
        mark("9d")
        wires = phase9e_wires(tmp, drops)
        phase9f_sosfilt(drops)
        mark("9e-9f")
        corpus = phase9g_corpus(tmp)
        mark("9g")
        phase9h_programs(drops, seg)
        mark("9h")
        phase10_profiles(drops, seg, k, ck, fk, corpus)
        mark("10")
    assert "jax" not in sys.modules, "the port loaded jax"
    loaded = [m for m in sys.modules
              if m == "axctdprocessor_tpu" or m.startswith("axctdprocessor_tpu.")]
    assert not loaded, f"the port loaded the JAX package: {loaded}"
    main_shape = k["shapes"][0]  # 600 s, the monolithic path's shape
    print(json.dumps({"kernels": [dict({
        "name": "tone_ratios", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": mono["launches"],
        "launches_per_decode_batch": bat["launches"],
        "launches_pipeline_8_batches": piped["launches"],
        "launches_archive_8_batches": arch["launches"],
        "launches_dp2_batch": multi["dp_launches"],
        "launches_two_device_pipeline_2_batches": multi["pipe_launches"],
        "launches_timeshard_decode": multi["timeshard_launches"],
        "launches_int4_decode_with_int8_retry": wires["retry_launches"],
        "max_abs_err": k["max_abs_err"], "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"], "bound_ms": main_shape["bound_us"] / 1e3,
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "bound_us": main_shape["bound_us"], "share_of_bound": main_shape["share_of_bound"],
        "shapes": [{key: s[key] for key in (
            "shape", "rows", "n", "stride", "n_win", "block_shape", "blocks", "ms", "device_ms",
            "standard_ms", "standard_device_ms", "plain_ms", "bound_us", "bound_by",
            "share_of_bound", "share_of_bound_device", "dft_core_matmul_ms",
            "dft_core_device_ms", "max_abs_err")}
            for s in k["shapes"]]}, launches_per_path=_per_path("tone_ratios"))]
        + [_streamed_entry(k)]
        + [_frontend_entry(name, fk) for name in FRONTEND_REPLACES]
        + [_chain_entry(name, ck[name]) for name in CHAIN_REPLACES]
        + [_chain_walk_entry(ck["chain_walk"][0])]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
