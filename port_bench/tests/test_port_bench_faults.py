"""Each cell's run with the timed path broken underneath comes out not
correct, and the unbroken run correct, at sizes a CPU holds: a state left
unchanged, half the batch left out (the mean over the rest), a token or an
answer altered where it is produced. One card has no exchange between
chips to leave out."""
import pytest

from port_bench.tests.helpers import run_small


@pytest.mark.parametrize("workload", [
    "tomo-tem-256.stream", "internlm2-1.8b.train_1k",
    "internlm2-1.8b.train_4k", "internlm2-1.8b.serve_2k"])
def test_port_bench_unbroken_run_is_correct(root, workload):
    result = run_small(root, workload)
    assert result["correct"] is True, result["checks"]


@pytest.mark.parametrize("workload, fault", [
    ("tomo-tem-256.stream", "state_unchanged"),
    ("tomo-tem-256.stream", "answer_altered"),
    ("internlm2-1.8b.train_1k", "state_unchanged"),
    ("internlm2-1.8b.train_1k", "half_batch"),
    ("internlm2-1.8b.train_4k", "state_unchanged"),
    ("internlm2-1.8b.train_4k", "half_batch"),
    ("internlm2-1.8b.serve_2k", "token_altered"),
])
def test_port_bench_broken_run_is_not_correct(root, workload, fault):
    result = run_small(root, workload, fault=fault)
    assert result["correct"] is False, result["checks"]
