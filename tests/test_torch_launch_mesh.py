"""``repro_torch.launch.mesh`` against ``repro/launch/mesh.py``: the
production meshes, (16, 16) over ('data', 'model') and (2, 16, 16) over
('pod', 'data', 'model'), built under torch's fake process group at world
256 and 512 (a mesh spans processes, so a group of that many must exist;
the fake one runs none), and the test mesh at its default and another
shape, each with the reference's shape and axis names, which the
reference builds on 512 virtual CPU devices in a subprocess."""
import textwrap

import pytest
import torch.distributed as dist

from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from tests.test_multidevice import run_with_devices

CASES = {"production": (256, lambda: make_production_mesh()),
         "production multi-pod": (512, lambda: make_production_mesh(
             multi_pod=True)),
         "test": (4, lambda: make_test_mesh()),
         "test 4 x 2": (8, lambda: make_test_mesh(data=4, model=2))}

_REFERENCE = """
    from repro.launch.mesh import make_production_mesh, make_test_mesh
    for name, mesh in (("production", make_production_mesh()),
                       ("production multi-pod",
                        make_production_mesh(multi_pod=True)),
                       ("test", make_test_mesh()),
                       ("test 4 x 2", make_test_mesh(data=4, model=2))):
        print(name, "|", tuple(mesh.devices.shape), "|", mesh.axis_names)
"""


@pytest.fixture(scope="module")
def reference():
    out = run_with_devices(textwrap.dedent(_REFERENCE), n=512)
    return {name.strip(): (shape.strip(), names.strip()) for name, shape,
            names in (line.split("|") for line in out.splitlines()
                      if "|" in line)}


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("case", list(CASES))
def test_torch_meshes_have_the_reference_shapes(reference, fake_group,
                                                case):
    world, make = CASES[case]
    fake_group(world)
    mesh = make()
    assert (str(tuple(mesh.shape)), str(mesh.mesh_dim_names)) == \
        reference[case]
    assert mesh.device_type == "cpu"


def test_torch_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="default group"):
        make_test_mesh()
