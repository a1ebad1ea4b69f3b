"""The port's sharding layer against the reference's: the rules, the spec
trees (parameters, ZeRO-1 moments, inputs) for every configuration, shape
and production mesh; ``Model.axes()`` and ``stack_cache_axes``;
``logical_to_spec``, ``shard`` and ``to_placements``; the meshes.

The port's meshes are real ``DeviceMesh``es over the ``fake`` process
group (no communication; 256 or 512 ranks in this one process), the
reference's an ``AbstractMesh`` with the ``devices`` its rules read."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro import sharding as jsharding  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import sharding as jls  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.config import SHAPES as JAX_SHAPES  # noqa: E402
from repro.models.config import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.models.transformer import is_axes_leaf as jax_is_axes_leaf  # noqa: E402
from repro.models.transformer import stack_cache_axes as jax_stack_cache_axes  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tls  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.models.transformer import is_axes_leaf, stack_cache_axes  # noqa: E402

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


class StubMesh(AbstractMesh):
    """The reference's rules read ``mesh.devices.shape``; an abstract mesh
    has no devices, so give it an array of its shape."""

    @property
    def devices(self):
        return np.empty(self.axis_sizes, dtype=object)


def _fake_group(world: int):
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


@pytest.fixture(scope="module", params=list(MESHES))
def meshes(request):
    """(the port's DeviceMesh from make_production_mesh on the fake group,
    the reference's stub), per production mesh. The rules and specs read
    only the mesh's names and shape, so the group is gone before the tests."""
    shape, names = MESHES[request.param]
    _fake_group(int(np.prod(shape)))
    try:
        mesh = tmesh.make_production_mesh(multi_pod=request.param == "multi_pod",
                                          device_type="cpu")
    finally:
        dist.destroy_process_group()
    assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == names
    return request.param, mesh, StubMesh(shape, names)


_REF = {}


def _reference(arch):
    """The reference's axes tree and parameter shapes of the full config."""
    if arch not in _REF:
        jm = jax_build(jax_config(arch))
        _REF[arch] = (jm.axes(), jm.param_shapes())
    return _REF[arch]


def _flat(tree, is_leaf):
    out = {}

    def walk(t, prefix):
        if is_leaf(t):
            out[prefix] = t
            return
        for k in sorted(t):
            walk(t[k], f"{prefix}.{k}" if prefix else k)
    walk(tree, "")
    return out


def _jax_flat(tree, is_leaf=None):
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {".".join(str(getattr(k, "key", k)) for k in path): v for path, v in leaves}


def _leaf_spec(x):
    return tuple(x) if x is not None else ()


# ---------------------------------------------------------------------------
# (a) rules and specs equal the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_spec_trees_equal_the_reference(meshes, arch, shape_name):
    kind, mesh, stub = meshes
    cfg, jcfg = get_config(arch), jax_config(arch)
    shape, jshape = SHAPES[shape_name], JAX_SHAPES[shape_name]
    assert (shape.seq_len, shape.global_batch, shape.mode) == \
        (jshape.seq_len, jshape.global_batch, jshape.mode)
    rules = tls.rules_for(cfg, shape, mesh)
    jrules = jls.rules_for(jcfg, jshape, stub)
    assert rules == jrules

    jaxes, jshapes = _reference(arch)
    model = build_model(cfg)
    axes = model.axes()
    specs = _flat(tls.spec_tree(axes, rules), lambda t: isinstance(t, tuple))
    jspecs = _jax_flat(jls.spec_tree(jaxes, jrules))
    assert set(specs) == set(jspecs)
    assert {k: v for k, v in specs.items()} == {k: _leaf_spec(v) for k, v in jspecs.items()}

    # the placements of every parameter on the port's mesh follow its spec
    shapes = model.param_shapes()
    shard_tree = tls.sharding_tree(axes, rules, mesh)
    for path, sh in _flat(shard_tree, lambda t: isinstance(t, sharding.MeshSharding)).items():
        assert sh.mesh is mesh and sh.spec == specs[path]

    zero = _flat(tls.zero_sharding_tree(shapes, axes, rules, mesh),
                 lambda t: isinstance(t, sharding.MeshSharding))
    jzero = _jax_flat(jls.zero_sharding_tree(jshapes, jaxes, jrules, stub),
                      lambda t: hasattr(t, "spec"))
    assert set(zero) == set(jzero)
    assert {k: v.spec for k, v in zero.items()} == \
        {k: _leaf_spec(v.spec) for k, v in jzero.items()}
    flat_shapes = _flat(shapes, lambda t: isinstance(t, torch.Tensor))
    for path, sh in zero.items():     # a spec DTensor can lay out on this mesh
        sh.placements(flat_shapes[path].dim())

    structs, shardings = tls.input_specs(cfg, shape, rules, mesh)
    jstructs, jshardings = jls.input_specs(jcfg, jshape, jrules, stub)
    assert {k: s for k, (s, _) in structs.items()} == \
        {k: tuple(v.shape) for k, v in jstructs.items()}
    assert {k: str(d).replace("torch.", "") for k, (_, d) in structs.items()} == \
        {k: str(v.dtype) for k, v in jstructs.items()}
    assert {k: v.spec for k, v in shardings.items()} == \
        {k: _leaf_spec(v.spec) for k, v in jshardings.items()}


# ---------------------------------------------------------------------------
# (b) the axes trees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_axes_and_cache_axes_equal_the_reference(arch):
    cfg = get_smoke_config(arch)
    model = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    axes = model.axes()
    jm = jax_build(jax_smoke(arch))
    jaxes = _jax_flat(jm.axes(), jax_is_axes_leaf)
    flat = _flat(axes, is_axes_leaf)
    assert flat == {k: v for k, v in jaxes.items()}

    # leaf for leaf with the parameters: one logical axis a dim
    params = _flat(model.params(), lambda t: isinstance(t, torch.Tensor))
    assert set(params) == set(flat)
    for path, p in params.items():
        assert len(flat[path]) == p.dim(), path
    meta = _flat(model.param_shapes(), lambda t: isinstance(t, torch.Tensor))
    assert {k: (tuple(v.shape), v.dtype) for k, v in meta.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
    assert all(v.device.type == "meta" for v in meta.values())

    assert _flat(stack_cache_axes(cfg), is_axes_leaf) == \
        _jax_flat(jax_stack_cache_axes(jax_smoke(arch)), jax_is_axes_leaf)
    cache = _flat(model.empty_cache(2, 8), lambda t: isinstance(t, torch.Tensor))
    cache_axes = _flat(stack_cache_axes(cfg), is_axes_leaf)
    assert set(cache) == set(cache_axes)
    assert all(len(cache_axes[k]) == v.dim() for k, v in cache.items())


# ---------------------------------------------------------------------------
# (c) logical_to_spec, shard, to_placements
# ---------------------------------------------------------------------------
RULES = {"batch": ("pod", "data"), "heads": "model", "kv_heads": "model", "embed": None,
         "seq": None, "mlp": "model", "vocab": "data"}


@pytest.mark.parametrize("axes", [
    ("batch", "seq", "heads", None),
    ("heads", "kv_heads"),            # model taken by heads: kv_heads drops it
    ("batch", "vocab"),               # data taken by batch: vocab has none left
    ("vocab", "batch"),               # vocab first: batch keeps only pod
    ("embed", "mlp", "heads"),
    (None, "unknown"),
])
def test_logical_to_spec_drops_repeated_axes_as_the_reference(axes):
    spec = sharding.logical_to_spec(axes, RULES)
    assert spec == _leaf_spec(jsharding.logical_to_spec(axes, RULES))
    used = [a for e in spec if e for a in ((e,) if isinstance(e, str) else e)]
    assert len(used) == len(set(used))


def test_without_rules_spec_is_empty_and_shard_is_the_identity():
    x = torch.randn(4, 6)
    assert sharding.current_rules() is None
    assert sharding.logical_to_spec(("batch", "seq")) == ()
    assert sharding.shard(x, ("batch", "seq")) is x


def test_use_rules_nests_and_restores():
    outer, inner = {"batch": "data"}, {"batch": None}
    with sharding.use_rules(outer, "m1"):
        with sharding.use_rules(inner, "m2"):
            assert sharding.current_rules() is inner and sharding.current_mesh() == "m2"
        assert sharding.current_rules() is outer and sharding.current_mesh() == "m1"
    assert sharding.current_rules() is None and sharding.current_mesh() is None


@pytest.fixture
def fake8():
    """A (2, 2, 2) pod/data/model DeviceMesh over an 8-rank fake group."""
    _fake_group(8)
    try:
        yield tmesh.make_host_mesh(model=2, data=2, pod=2, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_to_placements_splits_pod_major(fake8):
    pl = sharding.to_placements((("pod", "data"), None, "model"), fake8, 3)
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert sharding.to_placements((None, None), fake8, 2) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        sharding.to_placements((("data", "pod"),), fake8, 1)
    with pytest.raises(ValueError, match="not in"):
        sharding.to_placements(("expert",), fake8, 1)


def test_divisible_spec_falls_back_to_unsharded(fake8):
    spec = (("pod", "data"), "model", None)
    assert sharding.divisible_spec(spec, (8, 6, 3), fake8) == spec
    # batch 2 does not divide pod·data = 4; heads 1 (a decode query) not model = 2
    assert sharding.divisible_spec(spec, (2, 1, 3), fake8) == (None, None, None)
    assert sharding.divisible_spec(spec, (4,), fake8) == (("pod", "data"),)
    assert sharding.divisible_spec(("pod",), (3, 5), fake8) == (None, None)


def test_shard_redistributes_a_dtensor_only_when_its_layout_differs(fake8):
    rules = {"batch": ("pod", "data"), "heads": "model", "seq": None}
    x = distribute_tensor(torch.zeros(8, 4, 6), fake8, [Replicate()] * 3)
    before = sharding.shard.redistributes
    with sharding.use_rules(rules, fake8):
        y = sharding.shard(x, ("batch", "seq", "heads"))
        assert isinstance(y, DTensor) and tuple(y.placements) == (Shard(0), Shard(0), Shard(2))
        assert sharding.shard.redistributes == before + 1
        assert sharding.shard(y, ("batch", "seq", "heads")) is y
        assert sharding.shard.redistributes == before + 1
        # 3 heads do not divide the model axis: whole; batch 2 not pod·data
        z = sharding.shard(distribute_tensor(torch.zeros(2, 4, 3), fake8, [Replicate()] * 3),
                           ("batch", "seq", "heads"))
        assert tuple(z.placements) == (Replicate(),) * 3
        plain = torch.zeros(8, 4, 6)
        assert sharding.shard(plain, ("batch", "seq", "heads")) is plain


def test_shard_offset_follows_the_mesh_coordinate(fake8):
    x = distribute_tensor(torch.zeros(8, 12), fake8, [Shard(0), Replicate(), Shard(1)])
    assert sharding.shard_offset(x, 0) == (0, 4)     # rank 0: the first pod's rows
    assert sharding.shard_offset(x, 1) == (0, 6)


def test_group_axis_takes_the_dp_placement_iff_it_divides(fake8):
    from repro_torch.models import moe

    rules = {"batch": ("pod", "data")}
    assert moe._group_axis(8) is None               # no rules
    with sharding.use_rules(rules, fake8):
        assert moe._group_axis(8) == "batch"
        assert moe._group_axis(6) is None
    with sharding.use_rules({"batch": None}, fake8):
        assert moe._group_axis(8) is None


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
def test_mesh_needs_a_group_of_its_size(fake8):
    with pytest.raises(ValueError, match="needs a process group of 256 ranks"):
        tmesh.make_production_mesh(device_type="cpu")
    m = tmesh.make_host_mesh(model=2, data=4, device_type="cpu")
    assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (4, 2)
    assert tmesh.DEFAULT_DEVICE_TYPE == "cuda"


def test_rules_read_a_port_mesh_as_the_reference_reads_its_own(fake8):
    cfg = get_config("olmo_1b")
    shape = ShapeConfig("t", 32, 8, "train")
    jrules = jls.rules_for(jax_config("olmo_1b"), JaxShapeConfig("t", 32, 8, "train"),
                           StubMesh((2, 2, 2), ("pod", "data", "model")))
    assert tls.rules_for(cfg, shape, fake8) == jrules


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_recompute_sees_the_forward_rules_in_another_thread(remat):
    """On the card the autograd engine runs the backward, and so remat's
    recompute, in a thread of its own: the recompute re-installs the
    rules of the forward (without them a kernel's wrapper would be handed
    a DTensor)."""
    import threading

    from repro_torch.models import transformer

    seen = []

    def body(x):
        seen.append((threading.current_thread().name, sharding.current_rules()))
        return x * x

    rules = {"batch": ("pod", "data")}
    x = torch.ones(3, requires_grad=True)
    with sharding.use_rules(rules):
        y = transformer._remat(body, remat)(x).sum()
    worker = threading.Thread(target=y.backward, name="backward")
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert seen == [("MainThread", rules), ("backward", rules)]
    assert sharding.current_rules() is None
    assert torch.equal(x.grad, 2 * x.detach())


def test_a_local_call_refuses_dtensors_without_rules(fake8):
    x = distribute_tensor(torch.zeros(8, 4), fake8, [Replicate()] * 3)
    with pytest.raises(RuntimeError, match="without sharding rules"):
        sharding.local_call(lambda t: t, [(x, ("batch", None))], out_axes=[("batch", None)])
    plain = torch.zeros(2)
    assert sharding.local_call(lambda t: t + 1, [(plain, ("batch",))],
                               out_axes=[("batch",)]).tolist() == [1.0, 1.0]
