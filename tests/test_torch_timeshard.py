"""The port's time-sharded decode (``parallel.timeshard``) on the CPU.

Meshes are grids of the one CPU device (``[torch.device("cpu")] * k``).

Against the port's own unsharded pieces, on one 42 s drop cut into ``sp = 4``
blocks: the blocks' tone powers within 2e-4 relative of
``framed_tone_power_tiled`` over the whole row; given the **same** filtered
signal, the gathered and sorted crossing table equal to the monolithic
``find_crossings`` exactly, and the probes at those crossings within 1e-5
relative; the int16 row statistics reduced over the blocks within 1 float32
ulp of the whole row's mean and peak; the block filter with its warm-up halo
within 2e-5 of the whole-row filter; ``sp = 1`` (both halos zeros) equal to
``sp = 4`` in hexframes.

Against the JAX package, end to end: the two 42 s drops of
tests/test_parallel.py through JAX's ``decode_batch_timesharded`` on
``make_mesh({"dp": 2, "sp": 4})`` and the port's on the same shape: status,
metadata and trigger indices equal and the hexframe lists equal (measured:
agreement 1.0, 224 and 225 frames); the smoothed ratios of stage 1 within
2e-4 (six taps against JAX's prefix sum), the edge counts equal.  Marked
slow, each against JAX on ``{"dp": 1, "sp": 8}``: an int16 drop with a DC
offset, a 310 s drop and a 16 kHz drop.
"""

import numpy as np
import pytest
import torch

from axctdprocessor_tpu.parallel import batch as jbatch
from axctdprocessor_tpu.parallel import mesh as jmesh
from axctdprocessor_tpu.parallel import timeshard as jtimeshard
from axctdprocessor_tpu_torch.models import engine, simulator
from axctdprocessor_tpu_torch.ops import goertzel, iir
from axctdprocessor_tpu_torch.parallel import batch, timeshard
from axctdprocessor_tpu_torch.parallel.mesh import make_mesh
from axctdprocessor_tpu_torch.utils.config import DecoderConfig

torch.set_num_threads(2)

CPU = torch.device("cpu")
FS = 44100.0
CFG = DecoderConfig()


def _mesh(dp, sp):
    return make_mesh({"dp": dp, "sp": sp}, [CPU] * (dp * sp))


@pytest.fixture(scope="module")
def two_drops():
    """The first two drops of tests/test_parallel.py's ``small_batch``."""
    drops = []
    for i, serial in enumerate(["00123456", "0abc1234"]):
        spec = simulator.SimSpec(duration=42.0, profile_start=33.0, seed=20 + i,
                                 serial_hex=serial)
        pcm, truth = simulator.synthesize(spec)
        pcm = (pcm - np.mean(pcm)) / np.max(np.abs(pcm))
        drops.append((pcm.astype(np.float32), truth))
    return batch.pad_batch([p for p, _ in drops]), [t for _, t in drops]


@pytest.fixture(scope="module")
def one_row(two_drops):
    """Row 0 padded for ``sp = 4``, its dims and tables, and its blocks."""
    pcms, _ = two_drops
    row = timeshard.pad_for_mesh(pcms[:1], FS, 4)
    n = row.shape[1]
    dims = engine.EngineDims.for_waveform(n, FS, CFG.bitrate, engine.probe_window(CFG, FS))
    tables = {k: torch.from_numpy(v) for k, v in engine.engine_tables(CFG, FS, dims).items()}
    blocks = timeshard._upload_blocks(row, [CPU] * 4, n // 4)
    return torch.from_numpy(row[0]), dims, tables, blocks


def test_upload_blocks_are_views_of_one_upload(one_row):
    x, dims, _, blocks = one_row
    assert len(blocks) == 4 and all(b.shape == (1, dims.n // 4) for b in blocks)
    assert torch.equal(torch.cat(blocks, dim=1)[0], x)
    base = blocks[0].untyped_storage().data_ptr()
    assert all(b.untyped_storage().data_ptr() == base for b in blocks)


def test_block_powers_equal_whole_row_powers(one_row):
    """Each block's windows with the right raw halo (zeros after the last
    block) against the tiled powers of the whole row, zero-extended by one
    window: 2e-4 relative to the row's largest power per tone."""
    x, dims, tables, blocks = one_row
    block = dims.n // 4
    got = []
    for j, b in enumerate(blocks):
        right = timeshard._halo(blocks[j + 1] if j < 3 else None, slice(0, dims.n_power), b,
                                dims.n_power)
        got.append(timeshard.block_powers(b, right, tables["power_trig"], dims))
    got = torch.cat(got, dim=1)[0]
    assert got.shape == (4 * (block // dims.d_pcm), 3)
    x_ext = torch.cat([x, torch.zeros(dims.n_power)])
    want = goertzel.framed_tone_power_tiled(x_ext, dims.n_power, dims.d_pcm,
                                            tables["power_trig"])
    assert want.shape == got.shape
    scale = want.amax(dim=0, keepdim=True)
    assert float(((got - want).abs() / scale).max()) < 2e-4


def _whole_filter(x, dims, tables):
    nfft = iir.next_pow2(dims.n + 4096)
    return engine.fft_filter(x, tables["sos"], nfft)[: dims.n].to(x.dtype)


def test_block_filter_close_to_whole_row_filter(one_row):
    """The warm-up halo of 2048 samples settles the filter: each block's
    output within 2e-5 (absolute, on a signal of peak 1) of the whole-row
    filter's (measured: 3e-7)."""
    x, dims, tables, blocks = one_row
    block = dims.n // 4
    whole = _whole_filter(x, dims, tables)
    response = engine.sos_response_on_device(tables["sos"], timeshard.filter_nfft(block))
    assert timeshard.filter_nfft(block) == 2 ** 19  # 463,932 + 2,048 samples
    for j, b in enumerate(blocks):
        left = timeshard._halo(blocks[j - 1] if j else None,
                               slice(block - timeshard.WARMUP, block), b, timeshard.WARMUP)
        filt = timeshard.block_filter(b[0], left[0], response)
        assert filt.shape == (block,)
        assert float((filt - whole[j * block: (j + 1) * block]).abs().max()) < 2e-5, j


def test_crossing_table_equals_monolithic_on_the_same_filtered_signal(one_row):
    """Blocks cut from ONE filtered array: the gathered table, sorted, is the
    monolithic ``find_crossings`` exactly (the crossing between a block's
    last sample and the next block's first belongs to the left block), and
    the probes at every crossing are the monolithic probes within 1e-5."""
    x, dims, tables, _ = one_row
    block = dims.n // 4
    n_valid = torch.tensor(int(41.3 * FS))  # a zero-padded tail inside block 3
    whole = _whole_filter(x, dims, tables)
    halo = dims.npcm + CFG.bit_inset + 1
    cap = max(int(block / FS * 3000) + 256, 1024)
    cols = []
    for j in range(4):
        filt = whole[j * block: (j + 1) * block]
        right = whole[(j + 1) * block: (j + 1) * block + halo] if j < 3 else torch.zeros(halo)
        cols.append(timeshard.block_crossings(filt, right, n_valid, j, tables["bit_trig"],
                                              dims, FS, CFG.bit_inset, 100, cap))
    gpos, p1, p2, ovf = (torch.stack(c) for c in zip(*cols))
    assert int(ovf.max()) == 0
    gpos_s, order = torch.sort(gpos.reshape(-1), stable=True)
    want, n_cross, rovf = engine.find_crossings(whole, dims.n, 0, n_valid, 100,
                                                dims.max_crossings, FS)
    k = int(n_cross)
    assert k > 20000 and int(rovf) == 0
    assert int((gpos_s < timeshard.BIG).sum()) == k
    assert torch.equal(gpos_s[:k], want[:k])
    assert int(gpos_s[k]) == timeshard.BIG and int(want[k]) == engine.BIG
    probes = goertzel.tone_power_at(whole, want[:k] + CFG.bit_inset, dims.npcm,
                                    tables["bit_trig"])
    for got, col in ((p1, 0), (p2, 1)):
        got = got.reshape(-1)[order][:k]
        np.testing.assert_allclose(got.numpy(), probes[:, col].numpy(), rtol=1e-5, atol=1e-6)


def test_boundary_crossing_belongs_to_the_left_block():
    """A sign change between the last sample of block 0 and the first of
    block 1 is block 0's crossing, at global position block - 1; block 1's
    zero halo past the end of the row makes no crossing."""
    dims = engine.EngineDims.for_waveform(4 * 1764, FS, CFG.bitrate, 51)
    bit_trig = torch.from_numpy(goertzel.tone_matrix(51, [400.0, 800.0], FS, np.float32))
    block, halo = 2 * 1764, 51 + CFG.bit_inset + 1
    whole = torch.ones(2 * block)
    whole[block:] = -1.0
    n_valid = torch.tensor(2 * block)
    left = timeshard.block_crossings(whole[:block], whole[block: block + halo], n_valid, 0,
                                     bit_trig, dims, FS, CFG.bit_inset, 100, 1024)
    right = timeshard.block_crossings(whole[block:], torch.zeros(halo), n_valid, 1,
                                      bit_trig, dims, FS, CFG.bit_inset, 100, 1024)
    assert left[0][:2].tolist() == [block - 1, timeshard.BIG]
    assert right[0][0].item() == timeshard.BIG  # the last sample is masked by n_valid - 1


def test_int16_row_statistics_within_one_ulp_of_the_whole_row(two_drops):
    """The blocks' float32 sums and peaks reduced in shard order against the
    whole row's ``sum / n_valid`` and peak (``engine.condition_integer``):
    1 float32 ulp on the mean, the peak exact; the conditioned blocks within
    2 ulps of 1.0 of the whole row conditioned at once."""
    pcms, _ = two_drops
    raw = (np.round(pcms * 28000) + 500).astype(np.int16)
    raw = timeshard.pad_for_mesh(raw, FS, 4)
    lengths = np.asarray([pcms.shape[1], pcms.shape[1] - 70000], np.int64)
    raw[1, lengths[1]:] = 0
    block = raw.shape[1] // 4
    blocks = timeshard._upload_blocks(raw, [CPU] * 4, block)
    n_valid = {CPU: torch.from_numpy(lengths)}
    cond, mean, peak = timeshard._condition_blocks(blocks, n_valid, block)
    xf = torch.from_numpy(raw).to(torch.float32)
    want_mean = (xf.sum(-1) / torch.from_numpy(lengths).to(torch.float32)).numpy()
    assert mean.dtype == torch.float32
    assert np.all(np.abs(mean.numpy() - want_mean) <= np.spacing(np.abs(want_mean)))
    assert abs(float(mean[0]) - 500.0) < 1.0
    np.testing.assert_array_equal(peak.numpy(), xf.abs().amax(-1).numpy())
    whole = engine.condition_integer(torch.from_numpy(raw), raw.shape[1],
                                     torch.from_numpy(lengths))
    got = torch.cat(cond, dim=1)
    assert float((got - whole).abs().max()) <= 2 * float(np.spacing(np.float32(1.0)))
    assert float(got[1, lengths[1]:].abs().max()) == 0.0


@pytest.fixture(scope="module")
def ours(two_drops):
    pcms, _ = two_drops
    return timeshard.decode_batch_timesharded(pcms, FS, mesh=_mesh(2, 4))


def test_timeshard_decodes_the_drops(ours, two_drops):
    _, truths = two_drops
    for res, truth in zip(ours, truths):
        assert res.status == 2 and res.overflow == 0
        assert res.metadata["serial_no"] == truth["serial_no"]
        assert len(res.time) > 100


def test_sp1_equals_sp4_in_hexframes(ours, two_drops):
    """One block (both halos zeros, no neighbour) decodes, and to the same
    frames as four; so does ``dp = 1`` with both rows in one place."""
    pcms, _ = two_drops
    for shape in ((2, 1), (1, 4)):
        res = timeshard.decode_batch_timesharded(pcms, FS, mesh=_mesh(*shape))
        for a, b in zip(res, ours):
            assert a.status == 2 and a.hexframes == b.hexframes, shape
            assert a.metadata == b.metadata and a.time == b.time, shape


def test_timeshard_agrees_with_the_batch_path(ours, two_drops):
    """Against the port's own ``decode_batch`` (whole-row filter, edge-only
    probes): metadata and trigger indices equal, hexframe agreement >= 0.99
    (measured 1.0)."""
    pcms, _ = two_drops
    for res, ref in zip(ours, batch.decode_batch(pcms, FS, device="cpu")):
        assert res.metadata == ref.metadata
        assert (res.firstpulse400, res.profstartind) == (ref.firstpulse400, ref.profstartind)
        a, b = set(res.hexframes), set(ref.hexframes)
        assert len(a & b) / len(a | b) >= 0.99


def test_batch_not_a_multiple_of_dp_is_padded_and_cut(ours, two_drops):
    """Three ragged rows over ``dp = 2``: row 0 pads the batch and its copy
    is dropped; a shorter row with its true length decodes as it does alone."""
    pcms, _ = two_drops
    n = pcms.shape[1]
    three = np.concatenate([pcms, pcms[:1]])
    three[2, n - 30000:] = 0.0
    lengths = [n, n, n - 30000]
    res = timeshard.decode_batch_timesharded(three, FS, mesh=_mesh(2, 2), lengths=lengths)
    assert len(res) == 3 and [r.numpoints for r in res] == lengths
    for a, b in zip(res[:2], ours):
        assert a.hexframes == b.hexframes and a.metadata == b.metadata
    alone = timeshard.decode_batch_timesharded(three[2:], FS, mesh=_mesh(1, 2),
                                               lengths=lengths[2:])[0]
    assert res[2].hexframes == alone.hexframes and res[2].status == 2
    assert 0 < len(res[2].hexframes) < len(res[0].hexframes)


def test_sharded_stage1_wants_padded_input(two_drops):
    pcms, _ = two_drops
    with pytest.raises(ValueError, match="pad_for_mesh"):
        timeshard.sharded_stage1(pcms[:, :-1], FS, CFG, _mesh(1, 4))
    with pytest.raises(ValueError, match="pad_for_mesh"):  # whole strides per block
        timeshard.sharded_stage1(pcms[:, :-4], FS, CFG, _mesh(1, 4))
    with pytest.raises(ValueError, match="pad_to_multiple"):
        timeshard.sharded_stage1(np.concatenate([pcms, pcms[:1]]), FS, CFG, _mesh(2, 4))
    with pytest.raises(TypeError, match="mesh"):
        timeshard.decode_batch_timesharded(pcms, FS)


@pytest.fixture(scope="module")
def jax_run(two_drops):
    """JAX's ``decode_batch_timesharded`` on dp 2 x sp 4 (one compiled
    program for the module), with the stage-1 outputs it passed on."""
    pcms, _ = two_drops
    kept = {}
    real = jtimeshard.sharded_stage1

    def recording(*args, **kwargs):
        s1, dims = real(*args, **kwargs)
        kept.update({k: np.asarray(v) for k, v in s1.items()})
        return s1, dims

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jtimeshard, "sharded_stage1", recording)
        results = jtimeshard.decode_batch_timesharded(
            pcms, FS, mesh=jmesh.make_mesh({"dp": 2, "sp": 4}))
    return results, kept


def _assert_equal_to_jax(res, ref, bar=None):
    assert res.status == ref.status == 2
    assert res.metadata == ref.metadata
    assert (res.firstpulse400, res.profstartind) == (ref.firstpulse400, ref.profstartind)
    assert res.numpoints == ref.numpoints and res.overflow == ref.overflow == 0
    if bar is None:
        assert res.hexframes == ref.hexframes and len(res.hexframes) > 100
        assert res.time == ref.time and res.temperature == ref.temperature
    else:
        a, b = set(res.hexframes), set(ref.hexframes)
        assert len(a & b) / len(a | b) >= bar


def test_timeshard_equals_jax(ours, jax_run, two_drops):
    """Status, metadata, trigger indices, hexframes and the profile rows
    equal on both drops (no frame moved by FFT or sum rounding here)."""
    _, truths = two_drops
    jres, _ = jax_run
    assert len(ours) == len(jres) == 2
    for res, ref, truth in zip(ours, jres, truths):
        _assert_equal_to_jax(res, ref)
        assert res.metadata["serial_no"] == truth["serial_no"]
        assert res.fs == ref.fs


def test_stage1_close_to_jax(jax_run, two_drops):
    """The port's stage-1 dicts (one per ``dp`` place) against JAX's batched
    one: ``r7500`` within 2e-4 and ``r400`` within 2e-2 (six taps against
    JAX's float32 prefix sum, which after the 400 Hz pulse carries a total far
    above the later windows' power: measured 3.9e-5 and 9.2e-3, the port
    within 2e-6 of float64, see the next test); the edge tables as sets of
    samples at agreement >= 0.99 (FFT rounding moves crossings in the quiet
    start before the pulse, where the chain then walks differently: measured
    0.9975 and 0.9980), and the mark and space powers at the common edges within 1e-3."""
    pcms, _ = two_drops
    _, want = jax_run
    padded = timeshard.pad_for_mesh(pcms, FS, 4)
    stage1, dims = timeshard.sharded_stage1(padded, FS, CFG, _mesh(2, 4),
                                            lengths=[pcms.shape[1]] * 2)
    assert len(stage1) == 2 and dims.n == padded.shape[1]
    for i, s1 in enumerate(stage1):
        assert set(s1) == set(want)
        for key, tol in (("r400", 2e-2), ("r7500", 2e-4)):
            got, ref = s1[key][0].numpy(), want[key][i]
            assert got.shape == ref.shape == (padded.shape[1] // dims.d_pcm,)
            fin = np.isfinite(ref)
            np.testing.assert_array_equal(np.isfinite(got), fin)
            np.testing.assert_allclose(got[fin], ref[fin], rtol=tol, atol=tol)
        n_edges, jn_edges = int(s1["n_edges"][0]), int(want["n_edges"][i])
        assert abs(n_edges - jn_edges) < 0.01 * jn_edges and n_edges > 20000
        common, at, jat = np.intersect1d(s1["edge_samples"][0, :n_edges].numpy(),
                                         want["edge_samples"][i][:jn_edges],
                                         return_indices=True)
        share = len(common) / (n_edges + jn_edges - len(common))
        print(f"row {i}: edges {n_edges} / {jn_edges}, share in common {share:.4f}")
        assert share >= 0.99
        assert int(s1["overflow"][0]) == int(want["overflow"][i]) == 0
        for key in ("s1", "s2"):
            got, ref = s1[key][0].numpy()[at], want[key][i][jat]
            np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_gathered_ratios_close_to_float64(one_row):
    """The smoothed ratios of the gathered power series against the same
    windows, box mean and ratios in float64 numpy: 2e-5 absolute."""
    x, dims, _, _ = one_row
    stage1, _ = timeshard.sharded_stage1(x[None].numpy(), FS, CFG, _mesh(1, 4))
    n_win = dims.n // dims.d_pcm
    tm = goertzel.tone_matrix(dims.n_power, [400.0, 7500.0, CFG.dead_freq], FS)
    xe = np.concatenate([x.numpy().astype(np.float64), np.zeros(dims.n_power)])
    proj = np.stack([xe[i * dims.d_pcm: i * dims.d_pcm + dims.n_power] @ tm
                     for i in range(n_win)])
    powers = np.sqrt(proj[:, 0::2] ** 2 + proj[:, 1::2] ** 2)
    smooth = np.stack([powers[max(0, i - 5): i + 1].mean(0) for i in range(n_win)])
    for key, col in (("r400", 0), ("r7500", 1)):
        want = np.log10(smooth[:, col] / smooth[:, 2])
        got = stage1[0][key][0].numpy()
        assert np.isfinite(want).all() and got.shape == want.shape
        assert np.max(np.abs(got - want)) < 2e-5, key


def _jax_sp8(pcm, fs):
    return jtimeshard.decode_batch_timesharded(
        pcm[None, :], fs, mesh=jmesh.make_mesh({"dp": 1, "sp": 8}))[0]


@pytest.mark.slow
def test_timeshard_int16_device_conditioning_equals_jax():
    """int16 with a DC offset stays int16 across the upload; the row
    statistics reduced over eight blocks decode as JAX's psum/pmax do and as
    the host-conditioned float row does."""
    pcm, truth = simulator.synthesize()
    snd = (np.round(pcm * 28000 / np.max(np.abs(pcm))) + 500).astype(np.int16)
    mesh = _mesh(1, 8)
    res_raw = timeshard.decode_batch_timesharded(snd[None, :], 44100, mesh=mesh)[0]
    cond = ((snd.astype(np.float64) - np.mean(snd)) / np.max(np.abs(snd))).astype(np.float32)
    res_f32 = timeshard.decode_batch_timesharded(cond[None, :], 44100, mesh=mesh)[0]
    assert res_raw.metadata["serial_no"] == truth["serial_no"]
    assert res_raw.hexframes == res_f32.hexframes
    assert res_raw.temperature == res_f32.temperature
    _assert_equal_to_jax(res_raw, _jax_sp8(snd, 44100), bar=0.99)


@pytest.mark.slow
def test_timeshard_long_file_equals_jax():
    spec = simulator.SimSpec(duration=310.0, profile_start=33.0, seed=78)
    pcm, truth = simulator.synthesize(spec)
    x = ((pcm - np.mean(pcm)) / np.max(np.abs(pcm))).astype(np.float32)
    res = timeshard.decode_batch_timesharded(x[None, :], FS, mesh=_mesh(1, 8))[0]
    assert res.status == 2 and res.overflow == 0
    assert res.metadata["serial_no"] == truth["serial_no"]
    assert len(res.time) > 0.9 * (310.0 - 33.0) * 25
    assert res.time[-1] - res.time[0] > 0.9 * (310.0 - 33.0)
    _assert_equal_to_jax(res, _jax_sp8(x, FS), bar=0.99)


@pytest.mark.slow
def test_timeshard_low_fs_crossing_capacity_equals_jax():
    spec = simulator.SimSpec(fs=16000, duration=42.0, profile_start=33.0, seed=77)
    pcm, truth = simulator.synthesize(spec)
    pcm = ((pcm - np.mean(pcm)) / np.max(np.abs(pcm))).astype(np.float32)
    single = engine.decode_waveform(pcm, 16000, device="cpu", mode="monolithic")
    res = timeshard.decode_batch_timesharded(pcm[None, :], 16000, mesh=_mesh(1, 8))[0]
    assert res.status == single.status == 2 and res.overflow == 0
    assert res.metadata["serial_no"] == truth["serial_no"]
    a, b = set(res.hexframes), set(single.hexframes)
    assert len(a & b) / len(a | b) >= 0.99
    _assert_equal_to_jax(res, _jax_sp8(pcm, 16000), bar=0.99)
