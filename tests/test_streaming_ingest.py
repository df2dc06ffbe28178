"""StreamingDeviceSource: double-buffered async host->device ingest
(SURVEY section 7 "streaming vs jit"; reference analogue
sdr_thread.rs:9-37). The feeder thread must deliver the exact stream
(order, values, tail handling) while uploads run ahead of the
consumer."""
import numpy as np
import pytest

from gnss_sdr.receiver import ArraySource, StreamingDeviceSource


def _sig(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


class TestStreamingDeviceSource:
    def test_f32_exact_roundtrip(self):
        sig = _sig(10_000)
        src = StreamingDeviceSource(ArraySource(sig, 1e6), store="f32")
        got_re, got_im = [], []
        while True:
            out = src.read(1024)
            if out is None:
                break
            re, im = out
            got_re.append(np.asarray(re))
            got_im.append(np.asarray(im))
        re = np.concatenate(got_re)
        im = np.concatenate(got_im)
        assert re.size == sig.size
        np.testing.assert_array_equal(re, np.real(sig))
        np.testing.assert_array_equal(im, np.imag(sig))

    def test_int8_quantized_close(self):
        sig = _sig(8_192, seed=3)
        src = StreamingDeviceSource(ArraySource(sig, 1e6), store="int8")
        re, im = src.read(4096)
        re = np.asarray(re)
        # 8-bit over +/-4 sigma: worst-case quantization step
        step = 4.0 * np.std(np.real(sig)) / 127.0
        assert np.abs(re - np.real(sig)[:4096]).max() <= step
        assert src.read(4096) is not None
        assert src.read(4096) is None

    def test_short_tail_and_eos(self):
        sig = _sig(2_500)
        src = StreamingDeviceSource(ArraySource(sig, 1e6), store="f32")
        assert np.asarray(src.read(1000)[0]).size == 1000
        assert np.asarray(src.read(1000)[0]).size == 1000
        tail = src.read(1000)
        assert np.asarray(tail[0]).size == 500
        assert src.read(1000) is None

    def test_block_size_change_raises(self):
        src = StreamingDeviceSource(ArraySource(_sig(4000), 1e6))
        src.read(1000)
        with pytest.raises(ValueError):
            src.read(2000)

    def test_receiver_runs_on_streamed_source(self):
        """Full receiver over the streamed source (CPU): same tracking
        outcome as the plain array source."""
        from gnss_sdr import ReceiverConfig, RfConfig, TrackConfig
        from gnss_sdr.models import SatelliteScenario, synthesize
        from gnss_sdr.receiver import Receiver

        fs = 2_046_000.0
        sig = synthesize([SatelliteScenario(prn=7, doppler_hz=900.0,
                                            amplitude=0.4)],
                         int(0.3 * fs), fs, noise_std=1.0, seed=5)

        def run(source):
            rx = Receiver(
                ReceiverConfig(
                    rf=RfConfig(freq_if_hz=0.0,
                                output_sample_rate_hz=fs),
                    track=TrackConfig(n_channels=2),
                    block_ms=20,
                ),
                source,
            )
            return rx.run()

        s_plain = run(ArraySource(sig, fs))
        s_str = run(StreamingDeviceSource(ArraySource(sig, fs),
                                          store="f32"))
        assert s_str["tracked_prns"] == s_plain["tracked_prns"] == [7]
        assert s_str["blocks"] == s_plain["blocks"]


class TestOverlapProof:
    """The architectural claim: the feeder stays AHEAD of the consumer,
    so the device never starves on ingest (SURVEY section 7 "streaming
    vs jit"; reference analogue sdr_thread.rs:9-37). Proven with the
    overlap counters: a rate-limited consumer must never block in
    read() after the cold fill, while a rate-limited SOURCE must show
    up as consumer wait (the counters attribute, not just decorate)."""

    def test_feeder_stays_ahead_of_slow_consumer(self):
        import time

        src = StreamingDeviceSource(ArraySource(_sig(40 * 1000), 1e6),
                                    depth=3, store="f32")
        try:
            for _ in range(40):
                out = src.read(1000)
                assert out is not None
                time.sleep(0.002)      # consumer slower than feeder
            st = src.stats()
            # after the cold fill the queue was never empty at read
            # time: the consumer never blocked on ingest
            assert st["reads"] == 40
            assert st["consumer_wait_s"] < 0.010, st
            assert st["mean_queue_depth"] > 1.0, st
            assert st["max_queue_depth"] >= 2, st
        finally:
            src.close()

    def test_slow_source_shows_up_as_consumer_wait(self):
        import time

        class SlowSource:
            fs_hz = 1e6

            def __init__(self, arr):
                self._arr = arr
                self._pos = 0

            def read(self, n):
                time.sleep(0.01)       # link slower than the consumer
                out = self._arr[self._pos:self._pos + n]
                self._pos += n
                return out if out.size else None

        src = StreamingDeviceSource(SlowSource(_sig(20 * 1000)),
                                    depth=3, store="f32")
        try:
            for _ in range(20):
                assert src.read(1000) is not None
            st = src.stats()
            # ~10 ms per starved read, 19 post-cold reads
            assert st["consumer_wait_s"] > 0.05, st
        finally:
            src.close()
