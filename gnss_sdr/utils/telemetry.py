"""Telemetry accumulation and C/N0 estimation.

Observability surface matching (and exceeding) the reference's legacy
TrackingResult / NavigationView telemetry
(reference: src/tracking/tracking_bk.rs:24-43, src/view.rs:16-35): every
epoch's six correlators, loop errors, frequencies and lock state are
kept per channel, host-side, for decoding, plotting, and C/N0.

Storage is chunked numpy (one array slice appended per block), not
python lists: the receiver streams ~1000 epochs/s/channel and the
per-epoch ``list.append``/``tolist`` path measured ~10 ms per 500 ms
block at 32 channels — host overhead the device never sees. Field access
(``trace.i_p`` etc.) returns the concatenated array, cached until the
next append.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

_FIELDS = (
    "epoch_index", "global_sample", "i_p", "q_p", "i_e", "q_e",
    "i_l", "q_l", "carr_freq", "code_rate", "locked",
)
_EMPTY_DTYPES = {
    "epoch_index": np.int64, "global_sample": np.int64, "locked": bool,
}


class ChannelTrace:
    """Per-channel epoch-indexed history (chunked numpy, host).

    Every field in ``_FIELDS`` reads as a single concatenated numpy
    array (empty array before any epochs)."""

    def __init__(self, prn: int):
        self.prn = prn
        self._chunks: dict[str, list[np.ndarray]] = {
            f: [] for f in _FIELDS
        }
        self._cache: dict[str, np.ndarray] = {}

    def append_columns(self, **cols) -> None:
        """Append one block's worth of per-epoch columns (numpy)."""
        for name, v in cols.items():
            self._chunks[name].append(v)
        self._cache.clear()

    def __getattr__(self, name: str):
        # note: only reached when normal lookup fails; guard underscore
        # names so unpickling (__setstate__ probing) cannot recurse
        if name.startswith("_"):
            raise AttributeError(name)
        if name in _FIELDS:
            cache = self.__dict__["_cache"]
            if name not in cache:
                chunks = self.__dict__["_chunks"][name]
                if chunks:
                    cache[name] = np.concatenate(chunks)
                else:
                    cache[name] = np.empty(
                        0, _EMPTY_DTYPES.get(name, np.float32)
                    )
            return cache[name]
        raise AttributeError(name)

    def prompt(self) -> tuple[np.ndarray, np.ndarray]:
        return self.i_p, self.q_p

    def cn0_dbhz(self, coherent_s: float = 1e-3, window: int = 50) -> Optional[float]:
        """Narrowband/wideband power-ratio C/N0 estimate over the last
        ``window`` epochs (standard M of 20-ms NWPR estimator simplified
        to prompt-power statistics)."""
        i_p, q_p = self.prompt()
        if i_p.size < window:
            return None
        i_p, q_p = i_p[-window:], q_p[-window:]
        p_tot = np.mean(i_p.astype(np.float64) ** 2 + q_p.astype(np.float64) ** 2)
        p_sig = np.mean(np.abs(i_p.astype(np.float64))) ** 2
        p_noise = max(p_tot - p_sig, 1e-12)
        snr = p_sig / p_noise
        return float(10.0 * np.log10(max(snr, 1e-12) / coherent_s))


class TelemetryLog:
    """Accumulates device [T, C] telemetry blocks into per-channel traces."""

    def __init__(self, n_channels: int):
        self.n_channels = n_channels
        self.traces: dict[int, ChannelTrace] = {}   # channel -> live trace
        self.closed: list[ChannelTrace] = []

    def open_channel(self, channel: int, prn: int) -> None:
        if channel in self.traces:
            self.closed.append(self.traces[channel])
        self.traces[channel] = ChannelTrace(prn=prn)

    def close_channel(self, channel: int) -> None:
        if channel in self.traces:
            self.closed.append(self.traces.pop(channel))

    def append_block(self, telem, window_global_start: int) -> None:
        """``telem``: EpochTelemetry of [T, C] arrays for one block."""
        if not self.traces:
            return
        processed = np.asarray(telem.processed)
        names = ("i_p", "q_p", "i_e", "q_e", "i_l", "q_l",
                 "carr_freq", "code_rate")
        fields = {n: np.asarray(getattr(telem, n)) for n in names}
        epoch_idx = np.asarray(telem.epoch_index)
        start_off = np.asarray(telem.start_offset)
        locked = np.asarray(telem.locked)
        for ch, trace in self.traces.items():
            rows = np.nonzero(processed[:, ch])[0]
            if rows.size == 0:
                continue
            cols = {n: fields[n][rows, ch] for n in names}
            cols["locked"] = locked[rows, ch].astype(bool)
            cols["epoch_index"] = epoch_idx[rows, ch].astype(np.int64)
            cols["global_sample"] = (
                window_global_start + start_off[rows, ch].astype(np.int64)
            )
            trace.append_columns(**cols)

    def all_traces(self) -> list[ChannelTrace]:
        return list(self.traces.values()) + self.closed
