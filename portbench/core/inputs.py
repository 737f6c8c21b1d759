"""The general generator: synthetic AXCTD drops from a traffic mix's
parameters and the run's seed, written as int16 mono WAVs.

Every seed gives the same set of sizes (durations, rates, profile starts
are lists in the traffic file); the seed draws their order and each drop's
noise.  Drops are rendered by the frozen simulator
(``reference/simulator.py``), in parallel over the host's cores, in
processes that load no torch.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

SEED_MASK = (1 << 63) - 1


def drops_of(traffic: dict) -> list[dict]:
    """The traffic mix's drops: its ``drops`` list, or its ``kinds``, each
    ``count`` times (profile starts taken in turn from the kind's list)."""
    if "drops" in traffic:
        return [dict(d) for d in traffic["drops"]]
    out = []
    for kind in traffic["kinds"]:
        starts = kind["profile_start_s"]
        for i in range(int(kind["count"])):
            d = {k: v for k, v in kind.items() if k != "count"}
            d["profile_start_s"] = starts[i % len(starts)]
            out.append(d)
    return out


def drop_specs(seed: int, drops: list[dict]) -> list[dict]:
    """Each drop of the list with a noise seed drawn from `seed`, in an
    order drawn from `seed`.  A drop: ``duration_s``, ``fs``,
    ``profile_start_s`` and optionally ``noise_int16`` (uniform integer
    noise added to the int16 samples, as the archive corpus has)."""
    rng = np.random.default_rng(seed & SEED_MASK)
    order = rng.permutation(len(drops))
    seeds = rng.integers(0, 2**31 - 1, len(drops))
    return [dict(drops[i], seed=int(s)) for i, s in zip(order, seeds)]


def render(spec: dict, path: str) -> dict:
    """Synthesize one drop and write it to `path`; returns its sizes."""
    from ..reference import simulator

    sim = simulator.SimSpec(duration=float(spec["duration_s"]), fs=int(spec["fs"]),
                            profile_start=float(spec["profile_start_s"]), seed=spec["seed"])
    pcm, _ = simulator.synthesize(sim)
    pcm16 = np.round(pcm * (28000 / np.max(np.abs(pcm)))).astype(np.int16)
    noise = int(spec.get("noise_int16", 0))
    if noise:
        rng = np.random.default_rng(spec["seed"] + 1)
        pcm16 = np.clip(pcm16 + rng.integers(-noise, noise, len(pcm16)),
                        -32768, 32767).astype(np.int16)
    from scipy.io import wavfile

    wavfile.write(path, sim.fs, pcm16)
    return {"path": path, "samples": len(pcm16), "fs": sim.fs,
            "seconds": len(pcm16) / sim.fs}


def process_pool(n_jobs: int) -> ProcessPoolExecutor:
    """Fresh interpreters (spawn) that load the frozen reference alone."""
    workers = max(1, min(n_jobs, (os.cpu_count() or 2) - 1))
    return ProcessPoolExecutor(max_workers=workers,
                               mp_context=multiprocessing.get_context("spawn"))


def render_all(specs: list[dict], workdir: str, prefix: str = "drop") -> list[dict]:
    """Render every drop in parallel; returns their sizes in order."""
    paths = [os.path.join(workdir, f"{prefix}{i:03d}.wav") for i in range(len(specs))]
    with process_pool(len(specs)) as pool:
        return list(pool.map(render, specs, paths))
