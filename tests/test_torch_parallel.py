"""The port's multi-device paths (deepsir_tpu_torch/parallel/) against the
JAX package's (deepsir_tpu/parallel/) and against the port's own
single-device step, on the CPU with gloo.

One module fixture starts one process group of 4 processes
(`python tests/test_torch_parallel.py worker <rank> ...`, joined through
`initialize_from_env` and the DEEPSIR_* variables); each worker runs every
case below and writes its results, and each case is then reported as its
own test. The tests import JAX inside their bodies only, so that the
workers, which run this file, never load it. Widths as
tests/test_parallel.py's: 256 points, d_out (8, 16), 2 iterations, 4 pairs.

- The meshes (4, 1), (2, 2), (1, 4) and (2, 1): coordinates and groups.
- The ring and all-gather searches on a (1, 4) mesh, and the batched ring
  matcher on a (2, 2) mesh, equal JAX's `ring_nearest_neighbour_index`,
  `sharded_nearest_neighbour_index` and `make_ring_matcher` on the
  8-device virtual mesh index for index (run live here), tiled duplicates
  included (the lowest global index), on every rank alike.
- The sharded align eval step on (2, 2), with and without the mutual gate
  (tol 0.5), equals JAX's `make_sharded_eval_step`
  (tests/data/torch_parity_parallel.npz, whose JAX steps ran on exact
  float64 pyramids, which each rank's own pyramids are checked to equal):
  pred_idx equal, transforms within 1e-5.
- The sharded train step on (4, 1) and (2, 1), align, label
  (`fc_norm="batch"`, a different share of ignored labels in each pair) and
  feat, and align on (2, 2) through the ring matcher, equals the port's
  single-device `train_step` on the global batch (loss rtol 1e-5; each
  trained grad leaf within 1e-4 of its largest magnitude; params after the
  step within 1e-5, by the rules of
  tests/test_torch_pipelines.py for blind biases and Adam's first step near
  its eps) and JAX's `make_sharded_train_step` on (4, 1) (loss, its terms
  and the accuracy rtol 1e-5, params by the same rule). These hold with
  dropout off, since JAX draws its masks with another generator. Dropout:
  each rank draws the global batch's mask from a generator seeded alike and
  keeps its rows, so with dropout at 0.5 (align on (2, 1), label on
  (4, 1)) the sharded step still equals the port's single-device step.
- A NaN point in one rank's rows skips the step on every rank.
- `replicate_state` gives every rank the first rank's parameters and Adam
  state.
- The communication contract (the counterpart of
  tests/test_parallel.py's HLO check): with torch.distributed's
  collectives wrapped, the ring sends exactly one (B/d_data, M/d_model, C)
  shard per hop, d_model - 1 hops per search, and calls no all_gather or
  all_reduce; the all-gather strategy moves only the (d, N) fp32
  distances and int64 indices.
- `initialize_from_env`: without variables False and no group; with them a
  group of 4; a second call changes nothing.

And `python -m deepsir_tpu_torch.cli.train --data_parallel true --device
cpu` in 2 processes on Synthetic, 2 steps of 2 pairs at dropout 0.5,
against the 1-process run: the trained params within 1e-5. On one process:
`shard_batch`, each rank's pyramids against the fixture's,
`model_with_mesh_matcher`, the `Network.matcher` hook, and chip_smoke.py's
"parallel" phase at 1024 points.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from deepsir_tpu_torch.config import LossConfig, ModelConfig, RunConfig, TrainConfig  # noqa: E402
from deepsir_tpu_torch.models.network import ForwardOptions, Network  # noqa: E402
from deepsir_tpu_torch.ops.distance import nearest_neighbour_index  # noqa: E402
from deepsir_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from deepsir_tpu_torch.parallel.sharded import model_with_mesh_matcher, shard_batch  # noqa: E402
from deepsir_tpu_torch.training import (adam_count, device_batch, make_optimizer,  # noqa: E402
                                        train_step)
from deepsir_tpu_torch.utils.params import init_params, trainable_parameters  # noqa: E402

FIXTURE = ROOT / "tests" / "data" / "torch_parity_parallel.npz"
WORLD = 4
TIMEOUT = 300                      # seconds for each spawned process
MODEL = dict(feat_len=3, num_points=256, num_knn=8, sub_sampling_ratio=(4, 4), d_out=(8, 16),
             out_feat_dim=16, num_train_reg_iter=2, num_reg_iter=2, dropout_rate=0.0)
TRAIN = dict(lr=1e-3, lr_decay_epoch=1, lr_decay_ratio=0.5, lr_clip=3e-4)
SEED = 3                           # init_params, as the fixture
ADAM_EPS = 1e-8
# case -> (pipeline, ModelConfig options, meshes (num_data, num_model), held against JAX)
TRAIN_CASES = {
    "align": ("align", {}, ((4, 1), (2, 1), (2, 2)), True),
    "label": ("label", dict(fc_norm="batch"), ((4, 1), (2, 1)), True),
    "feat": ("feat", {}, ((4, 1), (2, 1)), True),
    "align-dropout": ("align", dict(dropout_rate=0.5), ((2, 1),), False),
    "label-dropout": ("label", dict(fc_norm="batch", dropout_rate=0.5), ((4, 1),), False),
}
EVAL_CASES = {"default": {}, "mutual": dict(mutual_check=True, mutual_check_tol=0.5)}
MESHES = ((4, 1), (2, 2), (1, 4), (2, 1))
# the searches: name -> (src shape, ref shape, tiled duplicate rows)
SEARCHES = {"plain": ((96, 16), (128, 16), 1), "ties": ((64, 8), (16, 8), 8)}
CONTRACT = dict(b=2, n=256, m=512, c=16)


def search_inputs(name):
    src_shape, ref_shape, tiles = SEARCHES[name]
    rng = np.random.default_rng(11)
    src = rng.normal(size=src_shape).astype(np.float32)
    ref = np.tile(rng.normal(size=ref_shape).astype(np.float32), (tiles, 1))
    return src, ref


def batched_inputs():
    rng = np.random.default_rng(12)
    return (rng.normal(size=(2, 96, 16)).astype(np.float32),
            rng.normal(size=(2, 128, 16)).astype(np.float32))


def run_configs(pipeline, options, thres_radius):
    return RunConfig(ModelConfig(**dict(MODEL, **options)),
                     LossConfig(thres_radius=float(thres_radius)), TrainConfig(**TRAIN), pipeline)


def step_arrays(fx, pipeline):
    keys = ("points_src", "points_ref", "transform_gt")
    if pipeline == "label":
        keys += ("labels_src", "labels_ref")
    return {k: fx[k] for k in keys}


def fresh(cfgs):
    model = Network(cfgs.model, cfgs.pipeline)
    model.load_state_dict(init_params(cfgs.model, seed=SEED, pipeline=cfgs.pipeline))
    return model, make_optimizer(model)


def step_record(model, out) -> dict:
    """A train step's results as numpy arrays."""
    rec = {"loss": out["loss"].numpy(), "skipped": np.asarray(out["skipped"])}
    if "acc" in out:
        rec["acc"] = out["acc"].numpy()
    for k, v in out.get("losses", {}).items():
        rec[f"losses/{k}"] = v.numpy()
    for name, p in trainable_parameters(model):
        rec[f"grad/{name}"] = out["grads"][name].numpy()
        rec[f"param/{name}"] = p.detach().numpy().copy()
    return rec


# ---------------------------------------------------------------- the workers

class _Recorder:
    """Wraps torch.distributed's collectives and records each call's name
    and its tensors' shapes and dtypes (batch_isend_irecv: each op's kind
    and peer)."""
    NAMES = ("all_gather", "all_gather_into_tensor", "all_reduce", "broadcast",
             "reduce_scatter", "all_to_all", "send", "recv", "batch_isend_irecv")

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch.distributed as dist
        self._real = {n: getattr(dist, n) for n in self.NAMES}
        for name, fn in self._real.items():
            setattr(dist, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, fn in self._real.items():
            setattr(dist, name, fn)

    def _wrap(self, name, fn):
        def wrapper(*args, **kwargs):
            if name == "batch_isend_irecv":
                ops = [[p.op.__name__, list(p.tensor.shape), str(p.tensor.dtype), p.peer]
                       for p in args[0]]
                self.calls.append([name, ops])
            else:
                tensors = [a for a in args if isinstance(a, torch.Tensor)]
                lists = [a for a in args if isinstance(a, list)]
                self.calls.append([name, [[list(t.shape), str(t.dtype)] for t in tensors],
                                   [len(x) for x in lists]])
            return fn(*args, **kwargs)
        return wrapper


def _worker(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist
    from deepsir_tpu_torch.parallel import (make_mesh, make_ring_matcher,
                                            make_sharded_eval_step, make_sharded_train_step,
                                            replicate_state, ring_nearest_neighbour_index,
                                            sharded_nearest_neighbour_index)
    from deepsir_tpu_torch.parallel.distributed import initialize_from_env
    torch.set_num_threads(1)
    res = {}
    res["env/none"] = np.asarray([initialize_from_env("cpu"), dist.is_initialized()])
    os.environ.update(DEEPSIR_COORDINATOR=f"localhost:{port}",
                      DEEPSIR_NUM_PROCESSES=str(world), DEEPSIR_PROCESS_ID=str(rank))
    first = initialize_from_env("cpu")
    group = dist.group.WORLD
    second = initialize_from_env("cpu")
    res["env/up"] = np.asarray([first, second, dist.get_world_size(), dist.get_rank(),
                                dist.group.WORLD is group])

    meshes = {shape: make_mesh(*shape) for shape in MESHES}
    for shape, mesh in meshes.items():
        tag = f"mesh/{shape[0]}x{shape[1]}"
        if mesh.coords is not None:
            res[f"{tag}/coords"] = np.asarray(mesh.coords)
            res[f"{tag}/data_ranks"] = np.asarray(mesh.data_ranks)
            res[f"{tag}/model_ranks"] = np.asarray(mesh.model_ranks)
            res[f"{tag}/sizes"] = np.asarray([dist.get_world_size(mesh.group),
                                              dist.get_world_size(mesh.data_group),
                                              dist.get_world_size(mesh.model_group)])
    try:
        make_mesh(3, 2)
    except ValueError as exc:
        res["mesh/too_big"] = np.asarray(str(exc))

    # the searches
    row = meshes[(1, 4)]
    for name in SEARCHES:
        src, ref = (torch.from_numpy(a) for a in search_inputs(name))
        res[f"search/{name}/ring"] = ring_nearest_neighbour_index(src, ref, row).numpy()
        res[f"search/{name}/gather"] = sharded_nearest_neighbour_index(src, ref, row).numpy()
    grid = meshes[(2, 2)]
    src, ref = (torch.from_numpy(a) for a in batched_inputs())
    rows = shard_batch(grid, {"src": src, "ref": ref})
    res["search/batched"] = make_ring_matcher(grid)(rows["src"], rows["ref"]).numpy()

    # the communication contract
    c = CONTRACT
    fs, fr = torch.zeros(c["b"], c["n"], c["c"]), torch.zeros(c["b"], c["m"], c["c"])
    for tag, mesh in (("ring-2x2", grid), ("ring-1x4", row)):
        part = shard_batch(mesh, {"fs": fs, "fr": fr})
        with _Recorder() as rec:
            make_ring_matcher(mesh)(part["fs"], part["fr"])
        res[f"contract/{tag}"] = np.asarray(json.dumps(rec.calls))
    with _Recorder() as rec:
        sharded_nearest_neighbour_index(fs[0], fr[0], row)
    res["contract/gather-1x4"] = np.asarray(json.dumps(rec.calls))

    fx = dict(np.load(FIXTURE))
    # the sharded eval step
    for case, options in EVAL_CASES.items():
        cfg = ModelConfig(**dict(MODEL, **options))
        model = Network(cfg)
        model.load_state_dict(init_params(cfg, seed=SEED))
        step = make_sharded_eval_step(model, cfg, grid, num_iter=MODEL["num_reg_iter"])
        transforms, out = step(shard_batch(grid, step_arrays(fx, "align")))
        res[f"eval/{case}/transforms"] = transforms.numpy()
        res[f"eval/{case}/pred_idx"] = out.pred_idx.numpy()
        assert model.matcher is None

    # the sharded train steps
    for case, (pipeline, options, shapes, _) in TRAIN_CASES.items():
        cfgs = run_configs(pipeline, options, fx["thres_radius"])
        for shape in shapes:
            mesh = meshes[shape]
            if mesh.coords is None:
                continue
            model, opt = fresh(cfgs)
            step = make_sharded_train_step(mesh)
            out = step(model, opt, cfgs, shard_batch(mesh, step_arrays(fx, pipeline)),
                       torch.Generator().manual_seed(0), 1)
            for k, v in step_record(model, out).items():
                res[f"train/{case}/{shape[0]}x{shape[1]}/{k}"] = v

    # one rank's NaN skips the step everywhere
    cfgs = run_configs("align", {}, fx["thres_radius"])
    model, opt = fresh(cfgs)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rows = shard_batch(meshes[(4, 1)], step_arrays(fx, "align"))
    if rank == 1:
        rows["points_src"] = rows["points_src"].copy()
        rows["points_src"][0, 5, 0] = np.nan
    out = make_sharded_train_step(meshes[(4, 1)])(model, opt, cfgs, rows,
                                                  torch.Generator().manual_seed(0), 1)
    res["guard"] = np.asarray([out["skipped"], adam_count(opt),
                               all(torch.equal(v, before[k])
                                   for k, v in model.state_dict().items())])

    # replicate_state: every rank from its own seed and its own local step
    model = Network(cfgs.model)
    model.load_state_dict(init_params(cfgs.model, seed=rank))
    opt = make_optimizer(model)
    local = {k: v[rank:rank + 1] for k, v in step_arrays(fx, "align").items()}
    train_step(model, opt, cfgs, local, torch.Generator().manual_seed(rank), 1)
    replicate_state(meshes[(4, 1)], model, opt)
    res["replicated/params"] = torch.cat([v.reshape(-1) for v in model.state_dict().values()])
    res["replicated/adam"] = torch.cat(
        [v.reshape(-1).float() for p in opt.param_groups[0]["params"]
         for v in opt.state[p].values()])
    res = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in res.items()}
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


# ---------------------------------------------------------------- the fixtures

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("DEEPSIR_")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    return env


def _run_all(cmds, cwd, env_of) -> list:
    """Run the commands at once; their outputs, after each has exited 0."""
    procs = [subprocess.Popen(cmd, cwd=cwd, env=env_of(i), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i, cmd in enumerate(cmds)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    port = free_port()
    _run_all([[sys.executable, __file__, "worker", str(r), str(WORLD), str(port), str(out)]
              for r in range(WORLD)], ROOT, lambda i: _env())
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURE))


@pytest.fixture(scope="module")
def single(fx):
    """The port's single-device step of each train case on the whole batch."""
    out = {}
    for case, (pipeline, options, _, _) in TRAIN_CASES.items():
        cfgs = run_configs(pipeline, options, fx["thres_radius"])
        model, opt = fresh(cfgs)
        step = train_step(model, opt, cfgs, step_arrays(fx, pipeline),
                          torch.Generator().manual_seed(0), 1)
        out[case] = (cfgs, model, step_record(model, step))
    return out


# ---------------------------------------------------------------- the checks

def test_initialize_from_env(ranks):
    for r, res in enumerate(ranks):
        assert res["env/none"].tolist() == [False, False]
        assert res["env/up"].tolist() == [True, True, WORLD, r, True]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_lays_ranks_out_row_by_row(ranks, shape):
    nd, nm = shape
    tag = f"mesh/{nd}x{nm}"
    for r, res in enumerate(ranks):
        if r >= nd * nm:
            assert f"{tag}/coords" not in res
            continue
        d, m = divmod(r, nm)
        assert res[f"{tag}/coords"].tolist() == [d, m]
        assert res[f"{tag}/data_ranks"].tolist() == [i * nm + m for i in range(nd)]
        assert res[f"{tag}/model_ranks"].tolist() == [d * nm + j for j in range(nm)]
        assert res[f"{tag}/sizes"].tolist() == [nd * nm, nd, nm]
    assert "mesh 3x2 needs more than the 4 ranks" in str(ranks[0]["mesh/too_big"])


@pytest.mark.parametrize("strategy", ["ring", "gather"])
@pytest.mark.parametrize("name", list(SEARCHES))
def test_search_equals_jax_on_every_rank(ranks, name, strategy):
    import jax
    import jax.numpy as jnp
    from deepsir_tpu.parallel import (make_mesh, ring_nearest_neighbour_index,
                                      sharded_nearest_neighbour_index)
    src, ref = search_inputs(name)
    mesh = make_mesh(num_data=1, num_model=WORLD, devices=jax.devices()[:WORLD])
    fn = ring_nearest_neighbour_index if strategy == "ring" else sharded_nearest_neighbour_index
    want = np.asarray(fn(jnp.asarray(src), jnp.asarray(ref), mesh, chunk=32))
    exact = np.argmin(((src[:, None] - ref[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(want, exact)
    for res in ranks:
        np.testing.assert_array_equal(res[f"search/{name}/{strategy}"], want)
    if SEARCHES[name][2] > 1:                       # duplicates: the first copy's row
        assert want.max() < SEARCHES[name][1][0]


def test_batched_ring_matcher_equals_jax(ranks):
    import jax
    import jax.numpy as jnp
    from deepsir_tpu.parallel import make_mesh, make_ring_matcher
    src, ref = batched_inputs()
    mesh = make_mesh(num_data=2, num_model=2, devices=jax.devices()[:4])
    want = np.asarray(jax.jit(make_ring_matcher(mesh, chunk=32))(jnp.asarray(src),
                                                                 jnp.asarray(ref)))
    for r, res in enumerate(ranks):
        d = r // 2                                  # the rank's data row
        np.testing.assert_array_equal(res["search/batched"], want[d:d + 1])


@pytest.mark.parametrize("tag", ["ring-2x2", "ring-1x4", "gather-1x4"])
def test_communication_contract(ranks, tag):
    c = CONTRACT
    for r, res in enumerate(ranks):
        calls = json.loads(str(res[f"contract/{tag}"]))
        if tag.startswith("ring"):
            nd, nm = (2, 2) if tag == "ring-2x2" else (1, 4)
            shard = [c["b"] // nd, c["m"] // nm, c["c"]]
            row = [(r // nm) * nm + j for j in range(nm)]
            me = row.index(r)
            assert len(calls) == nm - 1, calls         # one exchange per hop
            for name, ops in calls:
                assert name == "batch_isend_irecv"
                assert ops == [["isend", shard, "torch.float32", row[(me + 1) % nm]],
                               ["irecv", shard, "torch.float32", row[(me - 1) % nm]]]
        else:
            # one (d, N) gather each of the fp32 distances and int64 indices
            assert [call[0] for call in calls] == ["all_gather", "all_gather"], calls
            assert [call[1] for call in calls] == [[[[c["n"]], "torch.float32"]],
                                                   [[[c["n"]], "torch.int64"]]], calls
            assert [call[2] for call in calls] == [[4], [4]]


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_sharded_eval_step_equals_jax(ranks, fx, case):
    """Every rank's global outputs equal the port's single-device forward
    (pred_idx equal, transforms within 1e-6) and JAX's sharded step:
    pred_idx equal but for near ties between the two packages' fp32
    descriptors (chip_smoke._search_near_ties: at most 0.1% of rows, the
    float64 distances within 1e-5 of |s|^2 + |r|^2), transforms within 1e-5
    in each pair's iterations before its first differing match
    (chip_smoke.held_iterations)."""
    import chip_smoke
    cfg = ModelConfig(**dict(MODEL, **EVAL_CASES[case]))
    model = Network(cfg)
    model.load_state_dict(init_params(cfg, seed=SEED))
    searches = []

    def matcher(a, b):
        searches.append((a, b))
        return nearest_neighbour_index(a, b)
    model.matcher = matcher
    out = model.forward_align(device_batch(cfg, step_arrays(fx, "align"), device="cpu"),
                              ForwardOptions(num_iter=MODEL["num_reg_iter"], clip_weight=True))
    forward = searches[::2] if cfg.mutual_check else searches
    for res in ranks:
        np.testing.assert_array_equal(res[f"eval/{case}/pred_idx"], out.pred_idx.numpy())
        np.testing.assert_allclose(res[f"eval/{case}/transforms"], out.transforms.numpy(),
                                   rtol=0, atol=1e-6)
    want_idx = fx[f"eval/{case}/pred_idx"]
    for it, (fs, fr) in enumerate(forward):
        chip_smoke._search_near_ties(torch, fs, fr, out.pred_idx[it],
                                     torch.from_numpy(want_idx[it]).long())
    held = chip_smoke.held_iterations(out.pred_idx.numpy(), want_idx,
                                      np.ones(want_idx.shape[:2]))
    assert held.sum() >= want_idx.shape[0] * want_idx.shape[1] - 1, held
    for b, n in enumerate(held):
        np.testing.assert_allclose(out.transforms[:n, b].numpy(),
                                   fx[f"eval/{case}/transforms"][:n, b], rtol=0, atol=1e-5)


def _check_params(got, want, grads, own_grads, state0, blind, lr=TRAIN["lr"]):
    """Params after one step: within 1e-5 but for blind biases (left out)
    and the entries whose reference grad (`grads`) is below 100 Adam eps,
    where Adam's first step lr * g / (|g| + eps) turns the grads' rounding
    into up to lr / eps = 1e5 times as much: those (at most one entry or
    10% of a leaf) are held within 1e-7 to that update of the step's own
    grads (`own_grads`), which the leaf rule holds."""
    for key, value in want.items():
        if key in blind:
            continue
        eps_scale = np.abs(grads[key]) < 100 * ADAM_EPS
        assert eps_scale.sum() <= max(1, 0.1 * eps_scale.size), key
        np.testing.assert_allclose(got[key][~eps_scale], value[~eps_scale], rtol=0, atol=1e-5,
                                   err_msg=key)
        g = own_grads[key][eps_scale].astype(np.float64)
        own = state0[key].numpy()[eps_scale] - lr * g / (np.abs(g) + ADAM_EPS)
        np.testing.assert_allclose(got[key][eps_scale], own, rtol=0, atol=1e-7, err_msg=key)


def _leaves(rec, prefix):
    return {k[len(prefix):]: v for k, v in rec.items() if k.startswith(prefix)}


TRAIN_RUNS = [(case, shape) for case, (_, _, shapes, _) in TRAIN_CASES.items()
              for shape in shapes]


@pytest.mark.parametrize("case,shape", TRAIN_RUNS,
                         ids=[f"{c}-{s[0]}x{s[1]}" for c, s in TRAIN_RUNS])
def test_sharded_train_step_equals_single_device(ranks, single, case, shape):
    import test_torch_pipelines as P
    cfgs, model, want = single[case]
    tag = f"train/{case}/{shape[0]}x{shape[1]}/"
    got = _leaves(ranks[0], tag)
    blind = P.blind_biases(model)
    assert not got["skipped"] and not want["skipped"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for key in [k for k in want if k.startswith("losses/") or k == "acc"]:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-7, err_msg=key)
    grads, want_grads = _leaves(got, "grad/"), _leaves(want, "grad/")
    assert set(grads) == set(want_grads)
    largest = max(float(np.abs(g).max()) for g in want_grads.values())
    for key, ref in want_grads.items():
        if key in blind:
            assert max(np.abs(grads[key]).max(), np.abs(ref).max()) <= 1e-6 * largest, key
        else:
            P.assert_scaled(grads[key], ref, 1e-4, key)
    state0 = init_params(cfgs.model, seed=SEED, pipeline=cfgs.pipeline)
    _check_params(_leaves(got, "param/"), _leaves(want, "param/"), want_grads, grads, state0,
                  blind)
    # every rank of the mesh holds the same step
    for res in ranks[1:shape[0] * shape[1]]:
        for key, value in got.items():
            np.testing.assert_array_equal(res[tag + key], value, err_msg=key)


JAX_RUNS = [(case, shape) for case, shape in TRAIN_RUNS if TRAIN_CASES[case][3]]


@pytest.mark.parametrize("case,shape", JAX_RUNS,
                         ids=[f"{c}-{s[0]}x{s[1]}" for c, s in JAX_RUNS])
def test_sharded_train_step_equals_jax(ranks, single, fx, case, shape):
    import test_torch_pipelines as P
    cfgs, model, want = single[case]
    got = _leaves(ranks[0], f"train/{case}/{shape[0]}x{shape[1]}/")
    jax_step = _leaves(fx, f"train/{case}/")
    assert not got["skipped"] and not jax_step["skipped"]
    np.testing.assert_allclose(got["loss"], jax_step["loss"], rtol=1e-5)
    for key in [k for k in jax_step if k.startswith("losses/") or k == "acc"]:
        np.testing.assert_allclose(got[key], jax_step[key], rtol=1e-5, atol=1e-7, err_msg=key)
    params = _leaves(jax_step, "param/")
    assert set(params) == set(_leaves(got, "param/"))
    state0 = init_params(cfgs.model, seed=SEED, pipeline=cfgs.pipeline)
    _check_params(_leaves(got, "param/"), params, _leaves(want, "grad/"),
                  _leaves(got, "grad/"), state0, P.blind_biases(model))


def test_one_ranks_nan_skips_the_step_on_every_rank(ranks):
    for res in ranks:
        skipped, count, unchanged = res["guard"].tolist()
        assert skipped and count == 0 and unchanged


def test_replicate_state_gives_every_rank_the_first_ranks_state(ranks):
    assert np.abs(ranks[0]["replicated/adam"]).max() > 0
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["replicated/params"], ranks[0]["replicated/params"])
        np.testing.assert_array_equal(res["replicated/adam"], ranks[0]["replicated/adam"])


# ------------------------------------------------------------ the train command

CLI = ["--pipeline", "align", "--dataset_type", "Synthetic", "--num_points", "256",
       "--num_knn", "8", "--sub_sampling_ratio", "4", "4", "--d_out", "8", "16",
       "--out_feat_dim", "16", "--feat_len", "3", "-bs", "2", "--synthetic_train_size", "4",
       "--synthetic_eval_size", "2", "--max_epochs", "1", "-v", "0", "--num_workers", "1",
       "--data_parallel", "true", "--device", "cpu"]


def test_train_command_in_two_processes_equals_one(tmp_path):
    import test_torch_pipelines as P
    from deepsir_tpu_torch.utils.checkpoint import load_checkpoint
    port = free_port()
    one, two = tmp_path / "one", tmp_path / "two"
    module = [sys.executable, "-m", "deepsir_tpu_torch.cli.train"] + CLI

    def env_of(i):
        env = _env()
        if i > 0:
            env.update(DEEPSIR_COORDINATOR=f"localhost:{port}", DEEPSIR_NUM_PROCESSES="2",
                       DEEPSIR_PROCESS_ID=str(i - 1))
        return env
    outs = _run_all([module + ["--logdir", str(one)], module + ["--logdir", str(two)],
                     module + ["--logdir", str(two)]], ROOT, env_of)
    assert "Data parallel over mesh {'data': 2, 'model': 1}" in outs[1]
    runs = [sorted(d.iterdir()) for d in (one, two)]
    assert [len(r) for r in runs] == [1, 1]           # the second process writes nothing
    cfg = ModelConfig(**dict(MODEL, dropout_rate=0.5))
    models = [load_checkpoint(cfg, r[0] / "ckpt", device="cpu") for r in runs]
    start = init_params(cfg, seed=0)
    blind = P.blind_biases(models[0])
    moved = 0
    for (name, a), (_, b) in zip(trainable_parameters(models[0]),
                                 trainable_parameters(models[1])):
        moved += not torch.equal(a, start[name])
        if name not in blind:
            np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)
    assert moved > 0.9 * len(trainable_parameters(models[0]))


# --------------------------------------------------------- on one process

def _hand_mesh(num_data, num_model, rank):
    d, m = divmod(rank, num_model)
    grid = tuple(tuple(i * num_model + j for j in range(num_model)) for i in range(num_data))
    return Mesh({"data": num_data, "model": num_model}, grid, (d, m), None, None, None)


def test_shard_batch_keeps_this_ranks_rows_and_checks_divisibility():
    arrays = {"a": np.arange(8)[:, None] * np.ones((1, 3)), "b": np.arange(8)}
    for rank in range(4):
        rows = shard_batch(_hand_mesh(4, 1, rank), arrays)
        assert rows["b"].tolist() == [2 * rank, 2 * rank + 1]
        assert rows["a"].shape == (2, 3)
    assert shard_batch(_hand_mesh(2, 2, 3), arrays)["b"].tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="batch dim 8 of 'b' not divisible by data axis 3"):
        shard_batch(_hand_mesh(3, 1, 0), {"b": np.arange(8)})


def test_each_ranks_pyramids_equal_the_fixtures_exact_ones(fx):
    """The fixture's JAX steps ran on exact float64 pyramids
    (make_torch_parity_fixture.py::exact_pyramid), stored with it; each
    rank's rows of the batch on a data axis of 4 and of 2 give the port's
    pyramids equal to their rows of those, so that the port's sharded steps
    and JAX's start from the same pyramids."""
    cfg = ModelConfig(**MODEL)
    for num_data in (4, 2):
        for rank in range(num_data):
            mesh = _hand_mesh(num_data, 1, rank)
            batch = device_batch(cfg, shard_batch(mesh, step_arrays(fx, "align")), device="cpu")
            for side, pyr in (("src", batch.pyramid_src), ("ref", batch.pyramid_ref)):
                for field, levels in pyr._asdict().items():
                    for lvl, got in enumerate(levels):
                        key = f"pyr_{side}_{field}_{lvl}"
                        np.testing.assert_array_equal(got.numpy(),
                                                      shard_batch(mesh, {key: fx[key]})[key],
                                                      err_msg=f"{num_data} {rank} {key}")


def test_model_with_mesh_matcher_sets_the_ring_on_a_copy():
    cfg = ModelConfig(**MODEL)
    model = Network(cfg)
    assert model_with_mesh_matcher(model, _hand_mesh(4, 1, 0)) is model
    label = Network(cfg, "label")
    assert model_with_mesh_matcher(label, _hand_mesh(2, 2, 0)) is label
    clone = model_with_mesh_matcher(model, _hand_mesh(2, 2, 0))
    assert clone is not model and model.matcher is None and clone.matcher is not None
    assert all(a is b for a, b in zip(clone.parameters(), model.parameters()))
    assert list(clone.state_dict()) == list(model.state_dict())


@pytest.mark.parametrize("mutual", [False, True])
def test_network_searches_through_the_matcher_hook(fx, mutual):
    """A matcher that is the plain search gives the forward without it; under
    the mutual gate it is called twice, the second time with the clouds
    swapped, in place of the bidirectional search."""
    cfg = ModelConfig(**dict(MODEL, mutual_check=mutual, mutual_check_tol=0.5))
    model = Network(cfg)
    model.load_state_dict(init_params(cfg, seed=SEED))
    batch = device_batch(cfg, step_arrays(fx, "align"), device="cpu")
    opts = ForwardOptions(num_iter=2, clip_weight=True)
    want = model.forward_align(batch, opts)
    calls = []

    def matcher(a, b):
        calls.append((a.shape[1], b.shape[1]))
        return nearest_neighbour_index(a, b)
    model.matcher = matcher
    got = model.forward_align(batch, opts)
    n = MODEL["num_points"]
    assert len(calls) == (4 if mutual else 2)
    assert all(c == (n, n) for c in calls)
    torch.testing.assert_close(got.pred_idx, want.pred_idx, rtol=0, atol=0)
    torch.testing.assert_close(got.transforms, want.transforms, rtol=0, atol=1e-6)
    assert "matcher" not in "".join(model.state_dict())


def test_chip_smoke_parallel_phase_on_the_cpu():
    """chip_smoke.py's "parallel" phase at 1024 points, its train step on
    one pair, on the CPU (a gloo group of this one process; the plain
    versions, so no launch counts): the sharded steps equal the plain ones,
    the ring walks K2's search."""
    import chip_smoke
    import torch.distributed as dist
    launches, record = chip_smoke.check_parallel(torch, torch.device("cpu"), "cpu", n=1024,
                                                 pairs=1)
    assert not dist.is_initialized()
    assert launches == dict.fromkeys(chip_smoke.COUNTED, 0)
    assert record["backend"] == "gloo" and record["mesh"] == {"data": 1, "model": 1}
    assert set(record) >= {"train", "eval default", "eval F+gate", "ring"}
    assert record["train"]["param_err"] <= 1e-6
    assert record["ring"]["d4"]["near_ties"]["rows"] <= 1


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
