"""The port's push-style stream decoders, on the CPU.

``DeviceStreamDecoder`` first; at the end the host ``AXCTDStreamDecoder``
(over the port's parity engine), with the cases of tests/test_stream.py: fed
in pieces it equals the port's whole-file parity decode exactly, rows arrive
incrementally, a checkpoint resumes mid-stream, and one ragged chunking is
held against the JAX package's ``AXCTDStreamDecoder`` feed by feed.

Fed piecewise, ``finalize()`` must equal the port's offline segmented
decode of the concatenated samples exactly (README's stream contract), for
the three chunkings of tests/test_stream.py; snapshots grow as segments
land; a pinned decoder decodes the same.  Marked slow: the finalized
result against the JAX package's ``TPUStreamDecoder``.
"""

import numpy as np
import pytest
import torch

from axctdprocessor_tpu_torch.models import segmented, simulator
from axctdprocessor_tpu_torch.models.stream_device import DeviceStreamDecoder

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def stream_drop130():
    spec = simulator.SimSpec(duration=130.0, profile_start=33.0, seed=91)
    pcm, truth = simulator.synthesize(spec)
    x = ((pcm - np.mean(pcm)) / np.max(np.abs(pcm))).astype(np.float32)
    return x, truth


@pytest.fixture(scope="module")
def offline(stream_drop130):
    x, _ = stream_drop130
    return segmented.decode_waveform_segmented(x, 44100, device="cpu")


def _assert_same(res, ref):
    assert res.status == ref.status == 2
    assert res.metadata == ref.metadata
    assert res.firstpulse400 == ref.firstpulse400
    assert res.profstartind == ref.profstartind
    assert res.numpoints == ref.numpoints
    assert res.hexframes == ref.hexframes
    assert res.time == ref.time
    assert res.temperature == ref.temperature
    assert res.salinity == ref.salinity


def _feed(dec, x, chunking, rng):
    pos = 0
    while pos < len(x):
        if chunking == "uniform_1s":
            step = 44100
        elif chunking == "ragged":
            step = int(rng.integers(1000, 150000))
        else:
            step = 777 if pos < 10000 else len(x)
        dec.feed(x[pos: pos + step])
        pos += step


@pytest.mark.parametrize("chunking", ["uniform_1s", "ragged", "tiny_then_huge"])
def test_stream_equals_offline_segmented(stream_drop130, offline, chunking):
    x, truth = stream_drop130
    dec = DeviceStreamDecoder(44100, device="cpu")
    _feed(dec, x, chunking, np.random.default_rng(1234))
    res = dec.finalize()
    _assert_same(res, offline)
    assert res.metadata["serial_no"] == truth["serial_no"]
    assert dec.finalize() is res


def test_pinned_stream_decodes_the_same(stream_drop130, offline):
    """A decoder pinned to a 200 s bucket (larger than this stream's):
    the pin's padding does not change the decode."""
    x, _ = stream_drop130
    dec = DeviceStreamDecoder(44100, max_duration=200.0, device="cpu")
    assert dec._pin_bucket == segmented._bucket_count(9)
    _feed(dec, x, "uniform_1s", None)
    _assert_same(dec.finalize(), offline)


def test_latest_rows_incremental(stream_drop130, offline):
    x, _ = stream_drop130
    dec = DeviceStreamDecoder(44100, device="cpu")
    step = 2 * 44100
    seen, counts, n_seg = 0, [], 0
    for i in range(0, len(x), step):
        if dec.feed(x[i: i + step]) == n_seg:
            continue  # poll when a segment lands
        n_seg = dec._next_k
        rows = dec.latest_rows()
        seen += len(rows)
        counts.append(seen)
    assert counts == sorted(counts) and counts[-1] > 0, counts
    assert counts[-1] < len(offline.time)  # rows arrived before the end
    dec.finalize()
    seen += len(dec.latest_rows())
    assert seen == len(offline.time)
    assert dec.latest_rows() == []


def test_feed_after_finalize_raises(stream_drop130):
    x, _ = stream_drop130
    dec = DeviceStreamDecoder(44100, device="cpu")
    dec.feed(x[: 5 * 44100])
    res = dec.finalize()
    assert res.status in (0, 1, 2)
    with pytest.raises(RuntimeError):
        dec.feed(x[:100])


@pytest.mark.slow  # JAX compiles its per-segment and assemble programs
def test_stream_equals_jax_stream(stream_drop130):
    from axctdprocessor_tpu.models.stream_tpu import TPUStreamDecoder

    x, _ = stream_drop130
    ours = DeviceStreamDecoder(44100, device="cpu")
    ref = TPUStreamDecoder(44100)
    for i in range(0, len(x), 2 * 44100):
        ours.feed(x[i: i + 2 * 44100])
        ref.feed(x[i: i + 2 * 44100])
    a, b = ours.finalize(), ref.finalize()
    assert a.status == b.status == 2
    assert a.metadata == b.metadata
    assert a.firstpulse400 == b.firstpulse400
    assert a.profstartind == b.profstartind
    assert a.hexframes == b.hexframes
    assert a.time == b.time


# ---------------------------------------------------------------------------
# the host push decoder (models.stream) over the port's parity engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_drop():
    """The default 50 s drop, conditioned as ``read_wav`` conditions it, and
    the port's whole-file parity decode of it."""
    from axctdprocessor_tpu_torch.models import parity_engine

    pcm, _ = simulator.synthesize()
    raw = np.round(pcm * (32767 * 0.9 / np.max(np.abs(pcm)))).astype(np.int16)
    x = (raw.astype(np.float64) - np.mean(raw)) / np.max(np.abs(raw))
    return x, 44100, parity_engine.decode_waveform(x, 44100)


def _assert_host_same(res, ref):
    assert res.status == ref.status == 2
    assert res.firstpulse400 == ref.firstpulse400
    assert res.profstartind == ref.profstartind
    assert res.metadata == ref.metadata
    assert res.hexframes == ref.hexframes and len(res.hexframes) > 100
    np.testing.assert_array_equal(np.asarray(res.time), np.asarray(ref.time))
    np.testing.assert_array_equal(np.asarray(res.salinity), np.asarray(ref.salinity))


@pytest.mark.parametrize("chunking", ["uniform_1s", "ragged", "tiny_then_huge"])
def test_host_stream_equals_whole_file_parity(host_drop, chunking):
    from axctdprocessor_tpu_torch.models.stream import AXCTDStreamDecoder

    x, fs, whole = host_drop
    dec = AXCTDStreamDecoder(fs)
    _feed(dec, x, chunking, np.random.default_rng(1234))
    _assert_host_same(dec.finalize(), whole)


def test_host_stream_latest_rows_incremental(host_drop):
    from axctdprocessor_tpu_torch.models.stream import AXCTDStreamDecoder

    x, fs, whole = host_drop
    dec = AXCTDStreamDecoder(fs)
    seen, midstream = 0, False
    for pos in range(0, len(x), 2 * fs):
        dec.feed(x[pos: pos + 2 * fs])
        rows = dec.latest_rows()
        seen += len(rows)
        midstream |= bool(rows) and pos < len(x) - 4 * fs
    dec.finalize()
    seen += len(dec.latest_rows())
    assert midstream, "rows should appear before end of stream"
    assert seen == len(whole.time) and dec.latest_rows() == []


def test_host_stream_feed_after_finalize_or_abort_raises(host_drop):
    from axctdprocessor_tpu_torch.models.stream import AXCTDStreamDecoder

    x, fs, _ = host_drop
    for stop in ("finalize", "abort"):
        dec = AXCTDStreamDecoder(fs)
        dec.feed(x[: 5 * fs])
        getattr(dec, stop)()
        with pytest.raises(RuntimeError):
            dec.feed(x[:100])


def test_host_stream_checkpoint_resume(host_drop, tmp_path):
    """Snapshot mid-stream, resume from disk: the uninterrupted decode."""
    from axctdprocessor_tpu_torch.models.stream import AXCTDStreamDecoder

    x, fs, whole = host_drop
    cut = 20 * fs
    dec = AXCTDStreamDecoder(fs)
    dec.feed(x[:cut])
    dec.latest_rows()
    ckpt = str(tmp_path / "decoder.ckpt")
    dec.save_checkpoint(ckpt)
    del dec
    resumed = AXCTDStreamDecoder.load_checkpoint(ckpt)
    assert resumed.status >= 1
    resumed.feed(x[cut:])
    _assert_host_same(resumed.finalize(), whole)


def test_host_stream_equals_jax_host_stream(host_drop):
    """The same ragged pieces into the port's push decoder and the JAX
    package's (both host numpy): the same rows after every feed and the
    same final result."""
    from axctdprocessor_tpu.models.stream import AXCTDStreamDecoder as JaxStream
    from axctdprocessor_tpu_torch.models.stream import AXCTDStreamDecoder

    x, fs, whole = host_drop
    ours, ref = AXCTDStreamDecoder(fs), JaxStream(fs)
    rng = np.random.default_rng(1234)
    pos, n_rows = 0, 0
    while pos < len(x):
        step = int(rng.integers(1000, 150000))
        ours.feed(x[pos: pos + step])
        ref.feed(x[pos: pos + step])
        pos += step
        rows = ours.latest_rows()
        assert rows == ref.latest_rows()
        assert ours.status == ref.status
        n_rows += len(rows)
    a, b = ours.finalize(), ref.finalize()
    _assert_host_same(a, b)
    _assert_host_same(a, whole)
    np.testing.assert_array_equal(np.asarray(a.temperature), np.asarray(b.temperature))
    assert n_rows + len(ours.latest_rows()) == len(b.time)
