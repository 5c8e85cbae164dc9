"""The benchmark's own CPU tests (benchmark/tests) as one tier-1 test: a
subprocess from the root of the checkout runs them, every cell of
BENCHMARK.json at its tiny size (a run, the same seed twice, each fault
of its job, the control), the manifest, the counts and the harness's
additions. The tests that need a card are left out (-m "not cuda")."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_benchmark_tests_pass_on_the_cpu():
    env = dict(os.environ)
    env.pop("PYTEST_XDIST_WORKER", None)
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "benchmark/tests", "-q",
         "-m", "not cuda", "-p", "no:cacheprovider", "-p", "no:randomly",
         "-p", "no:xdist"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stdout[-6000:] + r.stderr[-3000:]
    assert " passed" in r.stdout and " failed" not in r.stdout
