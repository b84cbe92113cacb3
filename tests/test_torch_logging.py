"""The port's logging and check helpers (singa_tpu_torch.logging)
against the JAX package's (singa_tpu.logging): the same levels, the
``LOG`` / ``VLOG`` routing through the standard ``logging`` module,
``FATAL`` raising after it logs, and every ``CHECK*`` passing, failing
and returning as the reference's does."""

import logging

import pytest

from singa_tpu import logging as jlog
from singa_tpu_torch import logging as tlog

CHECKS = [("CHECK_EQ", 2, 2, 2, 3), ("CHECK_NE", 2, 3, 2, 2),
          ("CHECK_LT", 1, 2, 2, 2), ("CHECK_LE", 2, 2, 3, 2),
          ("CHECK_GT", 3, 2, 2, 2), ("CHECK_GE", 2, 2, 1, 2)]


def test_levels_and_names_match_the_reference():
    for name in ("INFO", "WARNING", "ERROR", "FATAL"):
        assert getattr(tlog, name) == getattr(jlog, name)
    assert set(tlog.__all__) == set(jlog.__all__) - {"LINT"}


@pytest.mark.parametrize("name,a,b,bad_a,bad_b", CHECKS)
def test_checks_pass_fail_and_return_as_the_reference(name, a, b, bad_a,
                                                      bad_b):
    assert getattr(tlog, name)(a, b) == getattr(jlog, name)(a, b) == a
    with pytest.raises(tlog.CheckError) as got:
        getattr(tlog, name)(bad_a, bad_b)
    with pytest.raises(jlog.CheckError) as want:
        getattr(jlog, name)(bad_a, bad_b)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, AssertionError)


def test_check_and_notnull():
    assert tlog.CHECK(5) == 5
    with pytest.raises(tlog.CheckError, match="nope"):
        tlog.CHECK(0, "nope")
    assert tlog.CHECK_NOTNULL(0) == 0
    with pytest.raises(tlog.CheckError, match="NOTNULL"):
        tlog.CHECK_NOTNULL(None)


def test_log_vlog_and_fatal(caplog):
    tlog.InitLogging("test_torch_logging")
    logger = logging.getLogger("singa_tpu_torch")
    assert logger.handlers and logger.level == tlog.INFO
    with caplog.at_level(logging.INFO, logger="singa_tpu_torch"):
        tlog.LOG(tlog.INFO, "epoch %d: loss=%.2f", 3, 0.5)
        tlog.SetVerbosity(1)
        try:
            tlog.VLOG(1, "shown %s", "v1")
            tlog.VLOG(2, "hidden")
        finally:
            tlog.SetVerbosity(0)
        with pytest.raises(tlog.CheckError, match="boom 7"):
            tlog.LOG(tlog.FATAL, "boom %d", 7)
    msgs = [r.getMessage() for r in caplog.records]
    assert msgs == ["epoch 3: loss=0.50", "shown v1", "boom 7"]
