"""The port's process-group helpers and its training CLI on a mesh against
the JAX package on the CPU: ``parallel/multihost.py`` in one process and on
four Gloo ranks, and ``python -m physicedit_torch.cli.train
--data_parallel 2 --device cpu`` on two Gloo ranks
(``tests/torch_dist_worker.py``) beside ``physicedit_tpu.cli.train
--data_parallel 2`` on two of JAX's virtual CPU devices, over the same tiny
tree and the same synthetic PhysicTran folder."""

import functools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import jax.numpy as jnp
from jax.experimental import pallas as pl

import physicedit_tpu.cli.train as j_cli
from physicedit_tpu.parallel import multihost as j_mh
from physicedit_tpu.pipeline.edit_pipeline import PhysicEditPipeline as JPipe
from physicedit_torch.parallel import multihost as t_mh
from physicedit_torch.train import synthetic
from tests.test_torch_io import DINO, build_tree, fake_tokenizer
from tests.test_torch_train_cli import CKPT_REL, _rel_l2
from tests.torch_dist_worker import run_world

torch.set_num_threads(2)


def test_dist_worker_imports_no_jax():
    """The Gloo worker imports torch and the port only (each rank also
    checks at its end that neither JAX nor the JAX package was loaded)."""
    import ast

    import tests.torch_dist_worker as worker

    names = set()
    for node in ast.walk(ast.parse(open(worker.__file__).read())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert names and not {n.split(".")[0] for n in names} & {"jax", "jaxlib",
                                                             "physicedit_tpu"}, names


def test_multihost_single_process_matches_jax():
    """One process: initialize_distributed does nothing (and again), the
    hybrid mesh is the plain mesh, the slice is the whole batch and the
    shards come back as the batch itself, as in the JAX package."""
    t_mh.initialize_distributed(device="cpu")
    t_mh.initialize_distributed(device="cpu")
    j_mh.initialize_distributed()
    assert not dist.is_initialized()
    assert t_mh.host_local_batch_slice(16) == j_mh.host_local_batch_slice(16) == (0, 16)
    batch = {"x": np.arange(24, dtype=np.float32).reshape(8, 3), "y": np.ones(8, np.float32)}
    try:
        mesh = t_mh.create_hybrid_mesh(1, 1, device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert t_mh.host_local_batch_slice(16, mesh) == (0, 16)
        got = t_mh.global_batch_from_host_shards(batch, mesh)
        want = j_mh.global_batch_from_host_shards(batch, j_mh.create_hybrid_mesh(4, 2))
        for k in batch:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert t_mh.is_main_process()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_multihost_on_gloo_ranks(tmp_path, world):
    """Gloo ranks on a (world / 2, 2) hybrid mesh: model groups are pairs of
    consecutive ranks, a global batch of 8 gives data coordinate c the rows
    [c * per, (c + 1) * per) (the two ranks of a model group load the same
    rows: D3, where JAX's unit is a host; at world 2 both load all 8), the
    shards come back on each rank, rank 0 is main."""
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    ranks = run_world("multihost", {"x": x}, world, str(tmp_path))
    per = 8 // (world // 2)
    for r, res in enumerate(ranks):
        c = r // 2
        assert res["slice"] == (per * c, per)
        assert torch.equal(res["x"], x[per * c:per * (c + 1)])
        assert res["model_ranks"] == [2 * c, 2 * c + 1]
        assert res["main"] == (r == 0)


LR = 1e-3


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The training CLI over four usable videos at --batch_size 2 (two
    steps), --data_parallel 2: the port on two Gloo ranks, the JAX package
    on a (2, 1) mesh of its virtual devices; both start from the tree's
    finetuned export."""
    root = tmp_path_factory.mktemp("train_dp")
    tree = build_tree(str(root / "tree"))
    synthetic.write_physictran_tree(str(root / "data"), n=5, excluded=1, frames=17, width=96,
                                    height=80, seed=4)
    argv = ["--dataset_base_path", str(root / "data"), "--base_model_path", tree["base"],
            "--dinov2_path", os.path.join(tree["base"], "dinov2", "model.safetensors"),
            "--height", "64", "--width", "64", "--num_frames", "17", "--lora_rank", "4",
            "--num_epochs", "1", "--learning_rate", str(LR), "--seed", "5",
            "--batch_size", "2", "--data_parallel", "2", "--loader_workers", "0",
            "--resume_from", tree["finetuned"]]
    out = {d: str(root / d) for d in ("port", "jax")}
    ranks = run_world("train_cli", {"argv": argv + ["--device", "cpu",
                                                    "--output_path", out["port"]]},
                      2, str(root / "world"), timeout=400)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        import imageio

        mp.setattr(imageio, "get_reader", synthetic.StandInReader)
        mp.setattr(JPipe, "load_tokenizer", lambda self, path: fake_tokenizer(self))
        load = JPipe.from_pretrained.__func__

        def from_pretrained(c, *a, **kw):
            pipe = load(c, *a, **dict(kw, dtype=jnp.float32))
            pipe.dinov2_cfg = DINO
            return pipe

        mp.setattr(JPipe, "from_pretrained", classmethod(from_pretrained))
        j_cli.main(argv + ["--output_path", out["jax"]])
    return out, ranks


def test_data_parallel_train_cli_matches_jax(dp_runs):
    """Both ranks took the same two steps with the same averaged losses, and
    the epoch-end checkpoint equals the JAX package's (each tensor within
    rel-L2 CKPT_REL, every element within 2 * lr * steps, as the
    single-process CLI tests hold it)."""
    from safetensors.numpy import load_file

    out, ranks = dp_runs
    assert all(r["step"] == 2 for r in ranks)
    assert ranks[0]["loss"] == ranks[1]["loss"] and all(np.isfinite(ranks[0]["loss"]))
    got = load_file(os.path.join(out["port"], "step-2.safetensors"))
    want = load_file(os.path.join(out["jax"], "step-2.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel_l2(got[k], want[k]) <= CKPT_REL, (k, _rel_l2(got[k], want[k]))
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2 * LR * 2, err_msg=k)
