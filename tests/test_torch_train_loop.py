"""The port's train loop on the CPU: the counterparts of
tests/test_training.py (the loss falls, bit-exact resume from a
checkpoint, the serve functions' shapes, the streaming trainer's CLI with
``--resume``), the remat policies giving the same gradients, and
``run_train`` feeding the producer's records to the step. The step
itself is held to the reference in tests/test_torch_training.py and
tests/test_torch_optim.py.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlayers
from repro_torch.models.registry import get_model
from repro_torch.training import (build_serve_fns, build_train_step,
                                  init_state, loss_and_grads)
from repro_torch.utils import tree_leaves
from tests.test_torch_training import _batch, _configs, _tbatch


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-3b-a800m",
                                  "recurrentgemma-2b", "whisper-medium",
                                  "rwkv6-7b"])
def test_torch_remat_policies_give_the_same_gradients(arch):
    """none, full and dots recompute the same function: the same loss and
    gradients, bit for bit on the CPU."""
    _, tcfg = _configs(arch)
    tcfg = tcfg.replace(attention_impl="naive")
    model = get_model(tcfg)
    params = model.init(torch.Generator().manual_seed(0), tcfg)
    batch = _tbatch(_batch(tcfg, 4))
    runs = {}
    for policy in ("none", "full", "dots"):
        loss, _, grads = loss_and_grads(params, batch,
                                        tcfg.replace(remat=policy))
        runs[policy] = (loss, tree_leaves(grads))
    for policy in ("full", "dots"):
        assert torch.equal(runs[policy][0], runs["none"][0]), policy
        for g, w in zip(runs[policy][1], runs["none"][1]):
            assert torch.equal(g, w), policy


def test_torch_remat_refuses_an_unknown_policy():
    with pytest.raises(ValueError, match="unknown remat policy"):
        tlayers.remat(lambda x: x, "some")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-3b-a800m",
                                  "rwkv6-7b"])
def test_torch_train_loss_decreases(arch):
    """The counterpart of tests/test_training.py::test_train_loss_decreases:
    15 steps overfitting one batch of 4 x 48 drop the loss by 0.3."""
    cfg = get_config(arch, reduced=True)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=40,
                          zero1=False)
    state = init_state(torch.Generator().manual_seed(0), cfg, opt)
    step = build_train_step(cfg, opt)
    batch = _tbatch(_batch(cfg, 1, b=4, s=48))
    losses = []
    for _ in range(15):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses
    assert np.isfinite(losses).all()


def test_torch_checkpoint_resume_bitexact(tmp_path):
    """The counterpart of tests/test_training.py::test_checkpoint_resume_
    bitexact: stop at step 5, save, restore, continue; every parameter
    equals an uninterrupted run's."""
    cfg = get_config("internlm2-1.8b", reduced=True)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=20,
                          zero1=False)
    step = build_train_step(cfg, opt)
    batches = [_tbatch(_batch(cfg, i, b=4, s=48)) for i in range(10)]

    state_a = init_state(torch.Generator().manual_seed(0), cfg, opt)
    for b in batches:
        state_a, _ = step(state_a, b)

    state_b = init_state(torch.Generator().manual_seed(0), cfg, opt)
    for b in batches[:5]:
        state_b, _ = step(state_b, b)
    save(str(tmp_path), 5, state_b)
    restored, at = restore(str(tmp_path), state_b)
    assert at == 5 and int(restored["opt"]["step"]) == 5
    for b in batches[5:]:
        restored, _ = step(restored, b)
    for pa, pb in zip(tree_leaves(state_a["params"]),
                      tree_leaves(restored["params"])):
        assert torch.equal(pa, pb)


def test_torch_serve_fns_shapes():
    """The counterpart of tests/test_training.py::test_serve_fns_shapes."""
    cfg = get_config("gemma-7b", reduced=True)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg)
    prefill, decode = build_serve_fns(cfg)
    with torch.inference_mode():
        logits, cache = prefill(params, {"tokens": torch.ones(
            (2, 10), dtype=torch.long)}, max_len=16)
        assert logits.shape == (2, 1, cfg.vocab_size)
        logits2, cache = decode(params, torch.ones((2, 1), dtype=torch.long),
                                cache)
    assert logits2.shape == (2, 1, cfg.vocab_size)
    assert int(cache["pos"]) == 11


def test_torch_streaming_trainer_cli_smoke(tmp_path):
    """The counterpart of tests/test_training.py::test_streaming_trainer_
    cli_smoke: ``launch/train.py`` end to end, then again with
    ``--resume``; the CLI itself wants CUDA and raises without it."""
    argv = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "4",
            "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--log-every", "10"]
    res = ttrain.run_train(ttrain.parse_args(argv), device="cpu")
    assert res["steps"] == 4 and res["step"] == 4
    assert np.isfinite(res["losses"]).all()
    assert res["launches"]["flash_attention"] == 0
    assert latest_step(str(tmp_path)) >= 4
    again = ttrain.run_train(ttrain.parse_args(argv + ["--resume"]),
                             device="cpu")
    assert again["step"] >= 4          # resumed from the checkpoint
    assert latest_step(str(tmp_path)) >= 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ttrain.main(argv)


def test_torch_streaming_trainer_trains_on_the_producers_records():
    """The stream's batches are the producer's records: ``run_train``'s
    losses equal ``build_train_step``'s on the same records, read from the
    broker as the stream reads them, partition by partition."""
    from repro_torch.core.broker import Broker, OffsetRange

    cfg = get_config("internlm2-1.8b", reduced=True)
    args = ttrain.parse_args(["--reduced", "--steps", "2", "--batch", "2",
                              "--seq", "16"])
    res = ttrain.run_train(args, device="cpu")
    broker = Broker()
    broker.create_topic("tokens", partitions=2)
    ttrain.synthetic_producer(broker, cfg, 2, 2, 16, 0)
    opt = OptimizerConfig(lr=args.lr, warmup_steps=5, total_steps=2,
                          zero1=False)
    state = init_state(torch.Generator().manual_seed(0), cfg, opt)
    step = build_train_step(cfg, opt)
    losses = []
    for i in range(2):
        records = []
        for part in (0, 1):
            rng = OffsetRange("tokens", part, 2 * i, 2 * i + 2)
            records += [r.value for r in broker.read(rng)]
        state, m = step(state, ttrain.assemble_batch(records[:2], cfg))
        losses.append(float(m["loss"]))
    assert losses == res["losses"]
    assert res["tokens"] == 2 * 2 * 16


def test_torch_train_creates_its_checkpoint_directory(tmp_path, monkeypatch):
    """The reference's trainer commits the stream's offsets to
    ``<ckpt-dir>/offsets.json`` after the first batch, and only a
    checkpoint's writer thread creates the directory, so with its default
    ``--ckpt-every 20`` a fresh ``--ckpt-dir`` raises ``FileNotFoundError``
    at the first commit (with a checkpoint every step it is a race between
    that thread and the commit); the port creates the directory first and
    trains and checkpoints in it."""
    import sys

    from repro.launch import train as jtrain

    fresh = tmp_path / "a" / "b"
    argv = ["--steps", "2", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(fresh), "--ckpt-every", "20"]
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    with pytest.raises(FileNotFoundError, match="offsets.json"):
        jtrain.main()
    fresh = tmp_path / "c" / "d"
    argv[argv.index("--ckpt-dir") + 1] = str(fresh)
    res = ttrain.run_train(ttrain.parse_args(["--reduced", *argv]),
                           device="cpu")
    assert res["steps"] == 2 and latest_step(str(fresh)) == 2
    assert (fresh / "offsets.json").is_file()
