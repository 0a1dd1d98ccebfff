"""The port's serving entry point on the CPU.

``run_serve`` at internlm2-1.8b's ``reduced()`` size serves 6 requests in
micro-batches of 4 (so the last batch is padded), on weights converted from
the reference's random init, in fp32; its greedy tokens are held to the
reference model's ``prefill``/``decode_step`` in fp32 on the same weights
and the same prompts (the prompts of ``repro/launch/serve.py``:
``default_rng(seed).integers``).
Also: no kernel launches on the CPU, and ``realtime_report`` equals the
reference's for the same batch history.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import Broker as JBroker
from repro.core import Context as JContext
from repro.core import StreamingContext as JStreamingContext
from repro.core.dstream import BatchInfo as JBatchInfo
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config
from repro_torch.core.broker import Broker
from repro_torch.core.dstream import BatchInfo, StreamingContext
from repro_torch.core.rdd import Context
from repro_torch.launch.serve import parse_args, run_serve
from repro_torch.models.convert import params_from_jax

ARGV = ["--reduced", "--requests", "6", "--batch", "4", "--prompt-len", "12",
        "--gen", "4", "--seed", "5"]


@pytest.fixture(scope="module")
def served():
    """One served stream on the reference's weights, both models in fp32
    (weights and activations), and those weights."""
    args = parse_args(ARGV)
    kw = dict(dtype="float32", param_dtype="float32")
    jcfg = jax_get_config(args.arch, reduced=True).replace(**kw)
    tcfg = get_config(args.arch, reduced=True).replace(**kw)
    jp = jtransformer.init(jax.random.PRNGKey(2), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    res = run_serve(args, device="cpu", params=tp, config=tcfg)
    assert res["config"] is tcfg
    return args, jcfg, jp, res


def test_torch_serve_flags_default_to_the_full_model():
    """--reduced is off unless given (the reference's cannot be turned
    off), and the other defaults are the reference's."""
    args = parse_args([])
    assert not args.reduced
    assert (args.arch, args.requests, args.batch, args.prompt_len, args.gen,
            args.seed) == ("internlm2-1.8b", 16, 4, 32, 16, 0)


def test_torch_serve_serves_every_request(served):
    args, _, _, res = served
    assert sorted(res["results"]) == list(range(args.requests))
    assert all(len(t) == args.gen for t in res["results"].values())
    assert res["tokens"] == args.requests * args.gen
    assert len(res["prefill_s"]) == len(res["decode_s"]) == 2   # 4 + 2 padded
    assert res["ttft_s"] == sorted(res["ttft_s"])
    assert res["report"]["batches"] == 2 and res["report"]["records"] == 6
    assert res["tokens_per_s"] > 0 and res["device"] == "cpu"


def test_torch_serve_launches_nothing_on_the_cpu(served):
    launches = served[3]["launches"]
    assert launches["flash_attention"] == 0
    assert set(launches.values()) == {0}


def test_torch_serve_tokens_match_the_jax_model(served):
    """The reference model, prefilled and decoded greedily on the same
    weights and prompts, batch by batch, gives the same tokens."""
    args, jcfg, jp, res = served
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, jcfg.vocab_size, (args.prompt_len,),
                            dtype=np.int32) for _ in range(args.requests)]
    for lo in range(0, args.requests, args.batch):
        batch = prompts[lo:lo + args.batch]
        batch += [batch[-1]] * (args.batch - len(batch))
        logits, cache = jtransformer.prefill(
            jp, {"tokens": jnp.asarray(np.stack(batch))}, jcfg,
            max_len=args.prompt_len + args.gen)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        outs = [np.asarray(tok)[:, 0]]
        for _ in range(args.gen - 1):
            logits, cache = jtransformer.decode_step(jp, tok, cache, jcfg)
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            outs.append(np.asarray(tok)[:, 0])
        want = np.stack(outs, axis=1)
        for i in range(min(args.batch, args.requests - lo)):
            assert res["results"][lo + i] == want[i].tolist(), lo + i


def test_torch_serve_draws_its_own_weights_from_the_seed():
    """Without weights, the model comes from --seed: two runs agree."""
    args = parse_args(["--reduced", "--requests", "2", "--batch", "2",
                       "--prompt-len", "5", "--gen", "2"])
    a = run_serve(args, device="cpu")["results"]
    assert a == run_serve(args, device="cpu")["results"]


@pytest.mark.parametrize("times,records", [
    ([], []),
    ([0.05, 0.08, 0.02], [4, 4, 2]),
    ([0.3, 0.01], [4, 1]),
])
def test_torch_realtime_report_matches_the_reference(times, records):
    """Both contexts, given the same batch history and interval, report
    the same keys and values."""
    ours = StreamingContext(Context(), Broker(), batch_interval=0.1)
    ref = JStreamingContext(JContext(), JBroker(), batch_interval=0.1)
    for i, (t, n) in enumerate(zip(times, records)):
        ours.history.append(BatchInfo(i, [], n, processing_time=t))
        ref.history.append(JBatchInfo(i, [], n, scheduled_at=0.0,
                                      processing_time=t))
    assert ours.realtime_report() == ref.realtime_report()
