"""The per-test time limit and the ``slow`` marks of the repository's root
``conftest.py``."""

import importlib.util
import re
import signal
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("root_conftest",
                                               ROOT / "conftest.py")
root_conftest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(root_conftest)


def test_time_limit_fails_a_sleeping_block_and_disarms():
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match="past its 1 s limit"):
        with root_conftest.time_limit(1, "the sleep"):
            time.sleep(10)
    assert time.monotonic() - t0 < 3
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)


def test_the_hook_fails_a_test_past_the_limit(pytester):
    """The root conftest, with its limit cut to 1 s, run as the conftest of
    a suite of its own in a separate process."""
    source = (ROOT / "conftest.py").read_text()
    pytester.makeconftest(re.sub(r"(?m)^LIMIT_S = .*$", "LIMIT_S = 1", source))
    pytester.mkdir("tests")
    (pytester.path / "tests" / "test_sleep.py").write_text(
        "import time\n\n\n"
        "def test_sleeps():\n    time.sleep(10)\n\n\n"
        "def test_returns():\n    pass\n")
    result = pytester.runpytest_subprocess("tests", "-p", "no:randomly")
    result.assert_outcomes(passed=1, failed=1)
    result.stdout.fnmatch_lines(
        ["*tests/test_sleep.py::test_sleeps ran past its 1 s limit*"])


def test_slow_marks_name_tests_of_the_jax_package():
    for nodeid in sorted(root_conftest.SLOW):
        path, name = nodeid.split("::")
        source = (ROOT / path).read_text()
        assert re.search(rf"^def {name.split('[')[0]}\(", source, re.M), nodeid
        assert "vectorsimilarity_tpu_torch" not in source, nodeid
