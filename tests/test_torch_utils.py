"""The port's copies of the reference's helpers (``repro_torch.utils``
against ``repro/utils.py``) on the same inputs: ``tree_bytes``,
``human_bytes``, ``ceil_div``, ``round_up``, ``asdict_shallow``,
``timed``, ``block_tree`` and ``peak_memory_bytes``, which reads the
dry-run's memory record as the reference reads ``memory_analysis()``."""
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import utils as ref
from repro_torch import utils

DTYPES = [("float32", torch.float32), ("bfloat16", torch.bfloat16),
          ("int8", torch.int8), ("int32", torch.int32),
          ("float16", torch.float16)]


@pytest.mark.parametrize("name,tdtype", DTYPES)
def test_torch_tree_bytes_equals_the_reference(name, tdtype):
    shapes = {"a": (3, 5), "b": [(7,), (2, 2, 2)], "c": ()}
    jtree = {"a": jnp.zeros(shapes["a"], name),
             "b": [jnp.zeros(s, name) for s in shapes["b"]],
             "c": jnp.zeros((), name)}
    ttree = {"a": torch.zeros(shapes["a"], dtype=tdtype),
             "b": [torch.zeros(s, dtype=tdtype) for s in shapes["b"]],
             "c": torch.zeros((), dtype=tdtype)}
    assert utils.tree_bytes(ttree) == ref.tree_bytes(jtree)
    # meta tensors count their shapes' bytes without memory
    meta = utils.tree_map(lambda t: t.to("meta"), ttree)
    assert utils.tree_bytes(meta) == ref.tree_bytes(jtree)


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1536, 2**20 - 1, 3 * 2**30,
                               7.5 * 2**40, 2**52, -2048])
def test_torch_human_bytes_equals_the_reference(n):
    assert utils.human_bytes(n) == ref.human_bytes(n)


@pytest.mark.parametrize("a", [0, 1, 7, 8, 9, 255, 256, 1000])
@pytest.mark.parametrize("b", [1, 8, 128])
def test_torch_ceil_div_and_round_up_equal_the_reference(a, b):
    assert utils.ceil_div(a, b) == ref.ceil_div(a, b)
    assert utils.round_up(a, b) == ref.round_up(a, b)


def test_torch_asdict_shallow_keeps_the_tensors():
    @dataclasses.dataclass
    class Rec:
        name: str
        x: object
        n: int = 3
    t = torch.ones(4)
    got = utils.asdict_shallow(Rec("r", t))
    assert got == {"name": "r", "x": t, "n": 3} and got["x"] is t
    arr = np.ones(4)
    assert ref.asdict_shallow(Rec("r", arr))["x"] is arr
    assert list(got) == list(ref.asdict_shallow(Rec("r", arr)))


def test_torch_timed_records_into_the_sink():
    ours, theirs = {}, {}
    with utils.timed("step", ours):
        sum(range(1000))
    with ref.timed("step", theirs):
        sum(range(1000))
    assert list(ours) == list(theirs) == ["step"]
    assert ours["step"] >= 0.0
    with utils.timed("nothing"):
        pass


def test_torch_block_tree_returns_the_tree():
    tree = {"a": torch.ones(3), "b": [torch.zeros(2), 5]}
    assert utils.block_tree(tree) is tree


@pytest.mark.parametrize("record,want", [
    ({"argument_bytes": 10, "output_bytes": 20, "temp_bytes": 30,
      "peak_bytes": 45}, 45),
    ({"argument_bytes": 10, "output_bytes": 20, "temp_bytes": 30}, 60),
    ({"argument_bytes": 10, "output_bytes": 20, "temp_bytes": 30,
      "alias_bytes": 20}, 40)])
def test_torch_peak_memory_bytes_reads_as_the_reference(record, want):
    """The record's 'peak_bytes' where it has one, else argument + output +
    temp less the aliased bytes: the reference's rule over
    ``memory_analysis()``'s fields."""
    assert utils.peak_memory_bytes(record) == want
    stats = SimpleNamespace(
        argument_size_in_bytes=record["argument_bytes"],
        output_size_in_bytes=record["output_bytes"],
        temp_size_in_bytes=record["temp_bytes"],
        alias_size_in_bytes=record.get("alias_bytes", 0))
    if "peak_bytes" in record:
        stats.peak_memory_in_bytes = record["peak_bytes"]
    assert ref.peak_memory_bytes(stats) == want
