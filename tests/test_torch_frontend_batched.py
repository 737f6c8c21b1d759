"""The port's batched demod front end against the JAX package's vmapped
stage-1 programs, on the CPU.

* ``SegmentedDecoder.segment`` over a group of 4 segments of the 130 s drop
  against ``_segment_program_grouped`` (``jax.vmap`` of the segment body):
  given JAX's conditioned and filtered arrays, the crossings, counts and
  flags exactly JAX's, the raw tone powers and probe ratios within rtol =
  atol = 2e-4; the port's own filter within 1e-5 of JAX's; every output of
  every segment of the group bit for bit the segment alone;
* ``FusedDecoder.stage1`` over a ragged batch of 3 short rows against
  ``parallel.pipeline._batched_stage1``: given JAX's filtered rows, the
  crossings, edges and edge counts exactly JAX's, the probes within 2e-4;
  the tone ratios within 0.02 (JAX's box mean is a float32 prefix sum);
  every row bit for bit the row alone;
* the whole decode of that batch against ``parallel.batch._batched_fused``:
  packed matrices as ``torch_packed`` states, every row bit for bit the
  row's own decode, hexframe sets and ``write_report`` bytes equal;
* the prestaged ``fused`` forward (every segment in one pass) against
  ``_resident_program``: packed vectors as ``torch_packed`` states, the
  forward bit for bit the group-by-group decode, hexframes and report bytes
  equal;
* ``chain.compact_indices_rowcap`` over rows (overflowing ones included)
  row for row the 1-D call and JAX's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from axctdprocessor_tpu.models import segmented as jseg
from axctdprocessor_tpu.models import tpu_engine as jeng
from axctdprocessor_tpu.ops import chain as jchain
from axctdprocessor_tpu.ops import iir as jiir
from axctdprocessor_tpu.parallel import batch as jbatch
from axctdprocessor_tpu.parallel import pipeline as jpipeline
from axctdprocessor_tpu.utils import report as jreport
from axctdprocessor_tpu.utils.config import DecoderConfig, resolve_settings
from axctdprocessor_tpu_torch.models import engine, segmented, simulator
from axctdprocessor_tpu_torch.ops import chain, goertzel
from axctdprocessor_tpu_torch.parallel import batch
from axctdprocessor_tpu_torch.utils import report
from torch_packed import assert_packed_close

torch.set_num_threads(2)

FS = 44100.0
TOL = dict(rtol=2e-4, atol=2e-4)
SETTINGS = {"triggerrange": [30, -1], "minR400": 2.0, "mindR7500": 1.5,
            "deadfreq": 3000.0, "pointsperloop": 100000,
            "mark_space_freqs": [400.0, 800.0], "use_bandpass": False}


def _int16(pcm):
    return np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)


def _report_bytes(res, jres, tmp_path):
    cfg = resolve_settings(SETTINGS)
    paths = tmp_path / "torch.txt", tmp_path / "jax.txt"
    report.write_report(str(paths[0]), res, "x.wav", [0, -1], SETTINGS, cfg)
    jreport.write_report(str(paths[1]), jres, "x.wav", [0, -1], SETTINGS, cfg)
    return paths[0].read_bytes(), paths[1].read_bytes()


# -- the segmented path: _segment_program_grouped and _resident_program -----

@pytest.fixture(scope="module")
def drop130():
    """The 130 s drop of JAX's tests/test_segmented.py, int16: 6 segments."""
    pcm, _ = simulator.synthesize(simulator.SimSpec(duration=130.0, profile_start=33.0, seed=91))
    return _int16(pcm)


@pytest.fixture(scope="module")
def group4(drop130):
    """Segments 1-4 of the drop as one group: the host statistics, the
    extensions, the port's module and JAX's grouped program's outputs."""
    cfg = DecoderConfig()
    model = segmented.SegmentedDecoder.from_config(cfg, FS, False, "cpu")
    raw = drop130
    dc = np.float32(np.mean(raw))
    peak = np.float32(max(int(raw.max()), -int(raw.min()), 1))
    ks = np.arange(1, 5)
    exts = np.zeros((4, model.in_len), np.int16)
    for i, k in enumerate(ks):
        lo = k * model.seg_len - segmented.LEFT_HALO
        s_lo, s_hi = max(lo, 0), min(lo + model.in_len, len(raw))
        exts[i, s_lo - lo: s_hi - lo] = raw[s_lo:s_hi]
    koffs = (ks * model.seg_len).astype(np.int32)
    dims = jeng.EngineDims.for_waveform(model.seg_len, FS, cfg.bitrate, model.npcm)
    ptrig, btrig, sos = jeng.engine_tables(cfg, FS, dims)
    tables = tuple(jnp.asarray(a, jnp.float32) for a in (ptrig, sos, btrig))
    prog = jseg._segment_program_grouped(FS, model.npcm, cfg.bit_inset, 100, True)
    want = tuple(np.asarray(o) for o in prog(
        jnp.asarray(exts), jnp.asarray(dc), jnp.asarray(peak), jnp.asarray(koffs),
        jnp.asarray(len(raw), jnp.int32), *tables, jnp.zeros((1, 6), jnp.float32)))

    def filt(ext, k_off, sos, dc, peak):  # the segment body's conditioning and filter
        x = ext.astype(jnp.float32)
        gpos = jnp.arange(model.in_len) + (k_off - segmented.LEFT_HALO)
        x = jnp.where((gpos >= 0) & (gpos < len(raw)), (x - dc) / peak, 0.0)
        spec = jnp.fft.rfft(x, model.nfft) * jeng.sos_response_on_device(sos, model.nfft)
        return x, jnp.fft.irfft(spec, model.nfft)[: model.ext_len].astype(jnp.float32)

    # dc and peak traced, as the program's arguments (a constant divisor
    # would become a multiplication by its reciprocal)
    x_j, f_j = (np.asarray(o) for o in jax.jit(jax.vmap(filt, in_axes=(0, 0, None, None, None)))(
        jnp.asarray(exts), jnp.asarray(koffs), tables[1], jnp.asarray(dc), jnp.asarray(peak)))
    return dict(model=model, exts=exts, koffs=koffs, dc=dc, peak=peak, n=len(raw),
                want=want, x_j=x_j, f_j=f_j)


def test_segment_group_equals_jax_grouped_program(group4):
    g = group4
    model = g["model"]
    offs = torch.from_numpy(g["koffs"].astype(np.int64))
    dc, peak = torch.tensor(g["dc"]), torch.tensor(g["peak"])
    powers, gpos, c0, cnt, rovf = g["want"]
    with torch.inference_mode():
        x, filt = model.filter_segment(torch.from_numpy(g["exts"]), offs, dc, peak, g["n"])
        same = model.probe_segment(torch.from_numpy(g["x_j"].copy()),
                                   torch.from_numpy(g["f_j"].copy()), offs, g["n"])
    np.testing.assert_array_equal(x.numpy(), g["x_j"])
    np.testing.assert_allclose(filt.numpy(), g["f_j"], rtol=0, atol=1e-5)
    s_powers, s_gpos, s_c0, s_cnt, s_rovf = (t.numpy() for t in same)
    np.testing.assert_array_equal(s_gpos, gpos.astype(np.int64))
    np.testing.assert_array_equal(s_cnt, cnt)
    np.testing.assert_array_equal(s_rovf, rovf)
    assert (cnt > 1000).all() and not rovf.any()
    np.testing.assert_allclose(s_powers, powers, **TOL)
    np.testing.assert_allclose(s_c0, c0, **TOL)


def test_segment_group_rows_equal_segments_alone(group4):
    """Every output of every segment of the group bit for bit the segment
    alone (the stream decoder's call), and a group of 2 the same."""
    g = group4
    model = g["model"]
    offs = torch.from_numpy(g["koffs"].astype(np.int64))
    dc, peak = torch.tensor(g["dc"]), torch.tensor(g["peak"])
    ext = torch.from_numpy(g["exts"])
    with torch.inference_mode():
        four = model.segment(ext, offs, dc, peak, g["n"])
        two = model.segment(ext[1:3], offs[1:3], dc, peak, g["n"])
        for i in range(4):
            alone = model.segment(ext[i], int(g["koffs"][i]), dc, peak, g["n"])
            for j, t in enumerate(alone):
                np.testing.assert_array_equal(four[j][i].numpy(), t.numpy())
                if 1 <= i < 3:
                    np.testing.assert_array_equal(two[j][i - 1].numpy(), t.numpy())


def test_prestaged_fused_forward_equals_jax_resident_program(drop130, tmp_path):
    """The drop staged at the int8 wire in groups of 4 (JAX's GROUP): the
    port's one-pass forward against JAX's ``_resident_program`` (its
    ``fused`` prestaged dispatch), and against the port's group-by-group
    decode bit for bit."""
    st = segmented.prestage_waveform(drop130, 44100, device="cpu", fused=True, group=4)
    groups = segmented.prestage_waveform(drop130, 44100, device="cpu", group=4)
    jst = jseg.prestage_waveform(drop130, 44100, fused=True)
    with torch.inference_mode():
        got = st.dispatch().numpy()
        np.testing.assert_array_equal(groups.dispatch().numpy(), got)
    want = np.asarray(jst.dispatch())
    assert_packed_close(got, want)
    res, jres = st.finish(torch.from_numpy(got)), jst.finish(jst.dispatch())
    assert res.status == jres.status == 2
    assert res.hexframes == jres.hexframes and len(res.hexframes) > 1000
    ours, ref = _report_bytes(res, jres, tmp_path)
    assert ours == ref


# -- the batch path: _batched_stage1 and _batched_fused ---------------------

@pytest.fixture(scope="module")
def ragged():
    """Three drops of 42-50 s, int16, zero-padded (``tests/test_torch_batch.py``'s)."""
    rows = [_int16(simulator.synthesize(simulator.SimSpec(
        duration=d, profile_start=33.0, seed=s))[0]) for d, s in ((45.0, 3), (50.0, 8), (42.0, 17))]
    return batch.pad_batch(rows), np.asarray([len(r) for r in rows], np.int32)


@pytest.fixture(scope="module")
def batch_setup(ragged):
    pcms, lengths = ragged
    cfg = DecoderConfig()
    n = pcms.shape[1]
    npcm = engine.probe_window(cfg, FS)
    dims = engine.EngineDims.for_waveform(n, FS, cfg.bitrate, npcm)
    jdims = jeng.EngineDims.for_waveform(n, FS, cfg.bitrate, npcm)
    ptrig, btrig, sos = (jnp.asarray(a) for a in jeng.engine_tables(cfg, FS, jdims))
    model = engine.FusedDecoder.from_numpy_tables(
        engine.engine_tables(cfg, FS, dims), dims, FS, bitrate=float(cfg.bitrate),
        bit_inset=cfg.bit_inset, device="cpu")
    return dict(cfg=cfg, dims=dims, jdims=jdims, tables=(ptrig, sos, btrig), model=model,
                x=torch.from_numpy(pcms), nv=torch.from_numpy(lengths.astype(np.int64)))


def test_stage1_equals_jax_batched_stage1(ragged, batch_setup):
    pcms, lengths = ragged
    b = batch_setup
    cfg, dims, jdims = b["cfg"], b["dims"], b["jdims"]
    ptrig, sos, btrig = b["tables"]
    want = {k: np.asarray(v) for k, v in jpipeline._batched_stage1(
        jdims, FS, float(cfg.bitrate), cfg.bit_inset, 100)(
        jnp.asarray(pcms), jnp.asarray(lengths), ptrig, sos, btrig).items()}

    def filt(pcm, n_valid):  # stage1_core's conditioning and filter
        x = jeng.condition_integer(pcm, jdims.n, n_valid)
        nfft = jiir.next_pow2(jdims.n + 4096)
        spec = jnp.fft.rfft(x, nfft) * jeng.sos_response_on_device(sos, nfft)
        return jnp.fft.irfft(spec, nfft)[: jdims.n].astype(x.dtype)

    f_j = torch.from_numpy(np.array(jax.jit(jax.vmap(filt))(jnp.asarray(pcms),
                                                            jnp.asarray(lengths))))
    with torch.inference_mode():
        got = {k: v.numpy() for k, v in b["model"].stage1(b["x"], b["nv"]).items()}
        cross, n_cross, rovf = engine.find_crossings(f_j, dims.n, 0, b["nv"], 100,
                                                     dims.max_crossings, FS)
        edge_idx, n_edges = chain.enumerate_bit_edges(cross, n_cross, FS, float(cfg.bitrate),
                                                      dims.max_edges)
        edges = torch.gather(cross, -1, torch.clamp(edge_idx, 0, dims.max_crossings - 1))
        probes = goertzel.probe_at(f_j, edges + cfg.bit_inset, dims.npcm,
                                          b["model"].bit_trig)
    np.testing.assert_array_equal(edges.numpy(), want["edge_samples"])
    np.testing.assert_array_equal(n_edges.numpy(), want["n_edges"])
    np.testing.assert_array_equal((rovf | (n_cross > dims.max_crossings)).numpy(),
                                  want["overflow"])
    assert (want["n_edges"] > 1000).all()
    np.testing.assert_allclose(probes[..., 0].numpy(), want["s1"], **TOL)
    np.testing.assert_allclose(probes[..., 1].numpy(), want["s2"], **TOL)
    for key in ("r400", "r7500"):
        fin = np.isfinite(want[key])
        np.testing.assert_array_equal(np.isfinite(got[key]), fin)
        # the box mean: JAX takes a float32 prefix sum, the port six taps
        # (``torch_packed``); up to 0.0134 here, where a window's powers are
        # small beside the prefix sum
        np.testing.assert_allclose(got[key][fin], want[key][fin], rtol=0, atol=2e-2)
    np.testing.assert_array_equal(got["overflow"], want["overflow"])


def test_stage1_rows_equal_rows_alone(batch_setup):
    """Every output of every row of the batch's stage 1 bit for bit the row
    as a batch of one, and the 1-D call."""
    b = batch_setup
    with torch.inference_mode():
        full = b["model"].stage1(b["x"], b["nv"])
        for r in range(3):
            one = b["model"].stage1(b["x"][r: r + 1], b["nv"][r: r + 1])
            flat = b["model"].stage1(b["x"][r], b["nv"][r])
            for key, v in full.items():
                np.testing.assert_array_equal(one[key][0].numpy(), v[r].numpy(), err_msg=key)
                np.testing.assert_array_equal(flat[key].numpy(), v[r].numpy(), err_msg=key)


def test_fused_batch_equals_jax_batched_fused(ragged, batch_setup, tmp_path):
    pcms, lengths = ragged
    b = batch_setup
    cfg, jdims = b["cfg"], b["jdims"]
    fi = jeng.fused_inputs(cfg, FS)
    want = np.asarray(jbatch._batched_fused(jdims, FS, float(cfg.bitrate), cfg.bit_inset, 100)(
        jnp.asarray(pcms), jnp.asarray(lengths), *b["tables"], fi["trig_i"], fi["trig_f"],
        fi["hdr_rel"], fi["calib_off"], fi["coeff_defaults"], fi["temp_lut"], fi["limits"]))
    with torch.inference_mode():
        got = b["model"](b["x"], b["nv"]).numpy()
        for r in range(3):
            np.testing.assert_array_equal(b["model"](b["x"][r], b["nv"][r]).numpy(), got[r])
    for r in range(3):
        assert_packed_close(got[r], want[r])
        n = int(lengths[r])
        res = engine.finish_result(got[r], 44100, n, FS, cfg)
        jres = jeng.finish_result(want[r], 44100, n, FS, cfg)
        assert res.status == jres.status == 2
        assert set(res.hexframes) == set(jres.hexframes) and len(res.hexframes) > 100
        ours, ref = _report_bytes(res, jres, tmp_path)
        assert ours == ref, r


# -- the crossing compaction over rows ---------------------------------------

@pytest.mark.parametrize("density,row_cap", [(0.05, 16), (0.3, 16), (0.6, 8)])
def test_compact_indices_rowcap_rows_equal_1d_and_jax(density, row_cap):
    """Rows of different lengths of set positions (the densest overflow the
    row cap), a size that truncates some rows: each row exactly the 1-D call
    and JAX's."""
    rng = np.random.default_rng(int(density * 100))
    n, size = 5_000, 900
    mask = rng.random((4, n)) < density
    mask[1, 3_000:] = False
    mask[3] = False
    gi, gt, go = chain.compact_indices_rowcap(torch.from_numpy(mask), size, 77, row_cap)
    assert gi.shape == (4, size) and gt.shape == go.shape == (4,)
    for r in range(4):
        oi, ot, oo = chain.compact_indices_rowcap(torch.from_numpy(mask[r]), size, 77, row_cap)
        np.testing.assert_array_equal(gi[r].numpy(), oi.numpy())
        assert int(gt[r]) == int(ot) and int(go[r]) == int(oo)
        wi, wt, wo = jchain.compact_indices_rowcap(jnp.asarray(mask[r]), size, 77, row_cap=row_cap)
        np.testing.assert_array_equal(gi[r].numpy(), np.asarray(wi))
        assert int(gt[r]) == int(wt) and int(go[r]) == int(wo)
    if density >= 0.3:
        assert go.any()
