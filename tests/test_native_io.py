"""Native C++ ingest runtime tests (conversion kernels, SPSC ring,
reader thread) against NumPy oracles."""
import ctypes

import numpy as np
import pytest

from gnss_sdr.io import NativeFileSource, convert, native_available
from gnss_sdr.io.native import load_library

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native library not built"
)


class TestConvert:
    def test_int8_real(self):
        raw = np.array([-128, -1, 0, 1, 127], np.int8)
        out = convert(raw, "int8_real")
        np.testing.assert_array_equal(out.real, raw.astype(np.float32))
        np.testing.assert_array_equal(out.imag, np.zeros(5))

    def test_int8_iq(self):
        raw = np.array([1, -2, 3, -4], np.int8)
        out = convert(raw, "int8_iq")
        np.testing.assert_array_equal(out, np.array([1 - 2j, 3 - 4j], np.complex64))

    def test_uint8_iq_rtlsdr_offset(self):
        raw = np.array([127, 128, 0, 255], np.uint8)
        out = convert(raw, "uint8_iq")
        np.testing.assert_allclose(
            out, np.array([-0.5 + 0.5j, -127.5 + 127.5j], np.complex64)
        )

    def test_int16_iq(self):
        raw = np.array([1000, -2000, 30000, -30000], np.int16)
        out = convert(raw, "int16_iq")
        np.testing.assert_array_equal(
            out, np.array([1000 - 2000j, 30000 - 30000j], np.complex64)
        )

    def test_matches_numpy_fallback(self):
        rng = np.random.default_rng(0)
        raw = rng.integers(-128, 128, 10000).astype(np.int8)
        native = convert(raw, "int8_iq")
        f = raw.astype(np.float32)
        ref = (f[0::2] + 1j * f[1::2]).astype(np.complex64)
        np.testing.assert_array_equal(native, ref)


class TestRing:
    def test_push_pop_wraparound(self):
        lib = load_library()
        ring = lib.ring_create(256)
        try:
            rng = np.random.default_rng(1)
            total_in, total_out = [], []
            for _ in range(50):
                data = rng.integers(0, 256, rng.integers(1, 200)).astype(np.uint8)
                pushed = lib.ring_push(
                    ring, data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    data.size,
                )
                total_in.append(data[:pushed].copy())
                out = np.empty(300, np.uint8)
                got = lib.ring_pop(
                    ring, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    out.size,
                )
                total_out.append(out[:got].copy())
            np.testing.assert_array_equal(
                np.concatenate(total_in), np.concatenate(total_out)
            )
        finally:
            lib.ring_destroy(ring)

    def test_capacity_rounds_to_pow2(self):
        lib = load_library()
        ring = lib.ring_create(1000)
        assert lib.ring_capacity(ring) == 1024
        lib.ring_destroy(ring)


class TestNativeFileSource:
    def test_streams_file_via_reader_thread(self, tmp_path):
        rng = np.random.default_rng(2)
        raw = rng.integers(-128, 128, 1_000_000).astype(np.int8)
        p = tmp_path / "cap.bin"
        p.write_bytes(raw.tobytes())

        src = NativeFileSource(str(p), 4e6, "int8_real", ring_bytes=1 << 16)
        chunks = []
        while (c := src.read(77_777)) is not None:
            chunks.append(c)
        src.close()
        got = np.concatenate(chunks)
        assert got.size == raw.size
        np.testing.assert_array_equal(got.real, raw.astype(np.float32))

    def test_missing_file_raises(self):
        with pytest.raises(FileNotFoundError):
            NativeFileSource("/nonexistent/file.bin", 1e6)

    def test_feeds_full_receiver(self, tmp_path):
        """Native ingest -> Receiver end-to-end."""
        from gnss_sdr.config import ReceiverConfig, RfConfig, TrackConfig
        from gnss_sdr.models import SatelliteScenario, synthesize_real_if_int8
        from gnss_sdr.receiver import Receiver

        fs, f_if = 4_092_000.0, 1_023_000.0
        raw = synthesize_real_if_int8(
            [SatelliteScenario(prn=30, doppler_hz=2000.0, amplitude=0.25)],
            int(0.3 * fs), fs, f_if, noise_std=1.0, scale=25.0,
        )
        p = tmp_path / "cap2.bin"
        p.write_bytes(raw.tobytes())
        src = NativeFileSource(str(p), fs, "int8_real")
        cfg = ReceiverConfig(
            rf=RfConfig(freq_if_hz=f_if, output_sample_rate_hz=fs,
                        enable_mixing=True, enable_dc_removal=True),
            track=TrackConfig(n_channels=4),
            block_ms=20,
        )
        rx = Receiver(cfg, src)
        out = rx.run()
        src.close()
        assert out["tracked_prns"] == [30]
