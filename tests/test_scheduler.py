"""Search-scheduler unit tests mirroring the reference's
AcquisitionManager tests (reference: do_acquisition.rs:339-395)."""
from gnss_sdr.config import AcqConfig
from gnss_sdr.receiver.acquisition import SearchMode, SearchScheduler


def test_initial_mode_cold():
    s = SearchScheduler(AcqConfig())
    assert s.mode == SearchMode.COLD


def test_mode_transitions():
    s = SearchScheduler(AcqConfig())
    s.update_mode(3)
    assert s.mode == SearchMode.WARM
    s.update_mode(5)
    assert s.mode == SearchMode.STEADY
    s.update_mode(0)
    assert s.mode == SearchMode.COLD


def test_cold_pacing_and_full_candidate_list():
    s = SearchScheduler(AcqConfig())
    interval, size = s.pacing()
    assert interval == 500
    cands = s.candidates(set())
    # all 32 PRNs searched cold (reference expects mask 0xFFFFFFFF)
    assert cands == list(range(1, 33))


def test_warm_filtering():
    s = SearchScheduler(AcqConfig())
    s.update_mode(3)
    interval, _ = s.pacing()
    assert interval == 1000
    cands = s.candidates({1, 2, 3})
    # first 8 untracked PRNs (reference expects mask 2040 = PRNs 4..11)
    assert cands == [4, 5, 6, 7, 8, 9, 10, 11]


def test_steady_pacing():
    s = SearchScheduler(AcqConfig())
    s.update_mode(9)
    interval, size = s.pacing()
    assert (interval, size) == (2000, 5)
    assert len(s.candidates({1, 2})) == 5


def test_due_and_mark():
    s = SearchScheduler(AcqConfig())
    assert s.due(0.0)
    s.mark_run(0.0)
    assert not s.due(499.0)
    assert s.due(500.0)
