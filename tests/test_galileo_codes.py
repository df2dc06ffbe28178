"""Galileo E1 memory-code loader (load_codes_hex) coverage.

The E1B/E1C primary codes are ICD memory codes (data, not LFSR
output); zero-egress environments run on the documented surrogate
family. These tests pin the LOADER path: hex round-trip, component
independence, surrogate-status reporting, and acquisition of a signal
built from loaded (non-surrogate) codes — so dropping in the real ICD
annex tables is a data-file operation, not a code change.

Reference claim being implemented: /root/reference/README.md:2
("decoding GNSS signals, including Galileo") — the reference contains
no Galileo code.
"""
from __future__ import annotations

import numpy as np
import pytest

from gnss_sdr.models.codes import galileo_e1 as gal


@pytest.fixture
def loaded_codes(tmp_path):
    """Write a 3-PRN hex fixture, load it, and restore the module to
    surrogate mode afterwards."""
    rng = np.random.default_rng(21)
    bits = rng.integers(0, 2, (3, gal.CODE_LENGTH), dtype=np.int64)
    path = tmp_path / "e1b_codes.txt"
    lines = ["# test fixture: 3 PRNs"]
    for row in bits:
        v = 0
        for b in row:
            v = (v << 1) | int(b)
        lines.append(f"{v:0{gal.CODE_LENGTH // 4}x}")
    path.write_text("\n".join(lines) + "\n")
    gal.load_codes_hex(str(path), "E1B")
    yield bits * 2 - 1
    gal._loaded_codes.pop("E1B", None)


class TestLoadCodesHex:
    def test_round_trip(self, loaded_codes):
        assert not gal.using_surrogate_codes("E1B")
        for prn in (1, 2, 3):
            np.testing.assert_array_equal(
                gal.generate_code(prn, "E1B"), loaded_codes[prn - 1])

    def test_components_independent(self, loaded_codes):
        # E1C stays surrogate while E1B is loaded
        assert gal.using_surrogate_codes("E1C")
        surrogate = gal._surrogate_code(1, "E1C")
        np.testing.assert_array_equal(
            gal.generate_code(1, "E1C"), surrogate)

    def test_prn_beyond_table_falls_back(self, loaded_codes):
        # table holds 3 PRNs; PRN 4 falls back to the surrogate
        np.testing.assert_array_equal(
            gal.generate_code(4, "E1B"), gal._surrogate_code(4, "E1B"))

    def test_restored_after_unload(self, tmp_path):
        assert gal.using_surrogate_codes("E1B")
        np.testing.assert_array_equal(
            gal.generate_code(1, "E1B"), gal._surrogate_code(1, "E1B"))

    def test_loaded_codes_acquire(self, loaded_codes):
        """A signal built from LOADED codes acquires through the
        BOC(1,1) PCPS path — proves the loader feeds the whole chain,
        so real ICD tables are drop-in."""
        from gnss_sdr.config import AcqConfig
        from gnss_sdr.models import get_signal
        from gnss_sdr.receiver.acquisition import AcquisitionEngine

        spec = get_signal("galileo_e1b")
        fs = 8_184_000.0
        code = gal.sample_code(2, spec.code_rate_hz, fs, "E1B", boc=True)
        n = code.size
        t = np.arange(2 * n) / fs
        doppler = 1200.0
        chips = np.tile(code, 2).astype(np.float64)
        sig = (0.5 * chips * np.exp(2j * np.pi * doppler * t)
               ).astype(np.complex64)
        rng = np.random.default_rng(3)
        sig += (0.3 * (rng.standard_normal(2 * n)
                       + 1j * rng.standard_normal(2 * n))
                ).astype(np.complex64)
        eng = AcquisitionEngine(
            AcqConfig(signal="galileo_e1b", n_prn=3, non_coherent_ms=8,
                      doppler_span_hz=8000.0, doppler_step_hz=400.0,
                      detection_threshold=2.0),
            spec, fs)
        cands = eng.search((np.real(sig).astype(np.float32),
                            np.imag(sig).astype(np.float32)))
        prns = {c.prn for c in cands}
        assert 2 in prns, f"loaded-code PRN 2 not acquired: {cands}"
        cand = next(c for c in cands if c.prn == 2)
        assert abs(cand.carrier_freq_hz - doppler) < 400.0


class TestSurrogateStatusSurfaced:
    def test_receiver_summary_reports_code_status(self):
        from gnss_sdr.config import (AcqConfig, ReceiverConfig,
                                         RfConfig, TrackConfig)
        from gnss_sdr.receiver import ArraySource, Receiver

        fs = 8_184_000.0
        with pytest.warns(UserWarning, match="SURROGATE"):
            rx = Receiver(
                ReceiverConfig(
                    rf=RfConfig(freq_if_hz=0.0,
                                output_sample_rate_hz=fs),
                    acq=AcqConfig(signal="galileo_e1b", n_prn=2),
                    track=TrackConfig(n_channels=2),
                    block_ms=4,
                ),
                ArraySource(np.zeros(65536, np.complex64), fs))
        s = rx.summary()
        assert s["code_status"] == {"surrogate_codes": True}
