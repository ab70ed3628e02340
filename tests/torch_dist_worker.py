"""Multi-process runs of the port for the tests: Gloo ranks on the CPU.

:func:`run_world` starts ``world`` processes of ``python -m
tests.torch_dist_worker JOB RANK``; each joins a Gloo group through a
``FileStore`` in the job's folder (no fixed port: several test workers run
at once), runs one case of :data:`CASES` on the job's inputs and writes its
result with ``torch.save``.  The parent waits with a timeout of its own,
then kills every rank and fails, so a deadlock cannot hang the suite.
This module imports torch and the port only, never JAX; every case checks
that no rank loaded it.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import traceback

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def run_world(name: str, inputs: dict, world: int, tmp_dir: str, timeout: float = 240.0):
    """Run case ``name`` on ``world`` Gloo ranks; returns each rank's result."""
    os.makedirs(tmp_dir, exist_ok=True)
    job = os.path.join(tmp_dir, f"{name}.job")
    torch.save({"case": name, "world": world, "inputs": inputs,
                "store": os.path.join(tmp_dir, f"{name}.store")}, job)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_", "TPU_", "PYTEST_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(tmp_dir, f"{name}.rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, "-m", "tests.torch_dist_worker", job,
                                       str(rank)], cwd=REPO, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    text = "".join(open(log.name).read()[-3000:] for log in logs)
    if hung:
        raise AssertionError(f"{name}: ranks {hung} still running after {timeout} s, "
                             f"killed\n{text}")
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"{name}: ranks {bad} failed\n{text}")
    return [torch.load(f"{job}.rank{r}.pt", weights_only=False) for r in range(world)]


def _rows(t, rank, world, dim=2):
    return t.chunk(world, dim=dim)[rank].contiguous()


def _leaf(x, grad):
    return x.clone().requires_grad_(grad)


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------

@case
def ring(inputs, rank, world):
    """ring_attention on this rank's rows of each call's full q/k/v (both
    lanes, a bias, gradients through a cotangent), and ulysses_attention."""
    from physicedit_torch.parallel import ring_attention as ra
    from physicedit_torch.parallel.sharding import MODEL_AXIS, create_mesh

    mesh = create_mesh(1, world, "cpu")
    out = {}
    for name, c in inputs["ring"].items():
        grad = c.get("g") is not None
        q, k, v = (_leaf(_rows(c[x], rank, world), grad) for x in ("q", "k", "v"))
        mask = None if c.get("mask") is None else _rows(c["mask"], rank, world, 1)
        bias = None if c.get("bias") is None else _rows(c["bias"], rank, world, 1)
        o = ra.ring_attention(q, k, v, mask, mesh, MODEL_AXIS, impl=c.get("impl"), bias=bias)
        res = {"out": o.detach()}
        if grad:
            o.backward(_rows(c["g"], rank, world))
            res.update(dq=q.grad, dk=k.grad, dv=v.grad)
        out[name] = res
    u = inputs["ulysses"]
    out["ulysses"] = {"out": ra.ulysses_attention(
        *(_rows(u[x], rank, world) for x in ("q", "k", "v")),
        _rows(u["mask"], rank, world, 1), mesh, MODEL_AXIS)}
    # ops.attention's ring route: full [B, S, N, D] in and out on every rank
    from physicedit_torch.models.dit import set_ring_context
    from physicedit_torch.ops.attention import attention

    set_ring_context(mesh, MODEL_AXIS)
    a = inputs["attention"]
    out["attention"] = {"out": attention(a["q"], a["k"], a["v"], key_mask=a["mask"],
                                         impl="ring")}
    return out


@case
def dit(inputs, rank, world):
    """The DiT with attn_impl="ring" over a (1, world) mesh: plain, with the
    EliGen bias, and tensor-parallel on the ring's axis (heads traded for
    sequence), each forward and the gradient of its LoRA factors."""
    from physicedit_torch.io.from_jax import dit_from_jax, lora_from_jax
    from physicedit_torch.models.dit import set_ring_context
    from physicedit_torch.parallel import sharding as shd

    mesh = shd.create_mesh(1, world, "cpu")
    set_ring_context(mesh, shd.MODEL_AXIS)
    x = inputs["x"]
    out = {}
    for name, (tp, use_bias) in {"ring": (False, False), "ring_bias": (False, True),
                                 "ring_tp": (True, False)}.items():
        dit = dit_from_jax(inputs["params"], inputs["cfg"], device="cpu")
        if tp:
            shd.shard_params(dit, shd.dit_param_specs(dit), mesh)
        lora = lora_from_jax(inputs["lora"], inputs["cfg"], device="cpu").requires_grad_(True)
        y = dit(*x["args"], txt_key_mask=x["mask"], attn_impl="ring", lora=lora,
                attn_bias_log2=x["bias_log2"] if use_bias else None)
        (y * x["cot"]).sum().backward()
        out[name] = {"out": y.detach(), "grads": {n: p.grad.clone()
                                                  for n, p in lora.named_parameters()}}
    return out


@case
def pipeline(inputs, rank, world):
    """shard() of the tiny pipeline at (1, world) and one edit; then, on a
    fresh copy at (2, world / 2): edit_batch and edit_batch_mixed split over
    the data axis, and the reasoner on the tensor-parallel VL model."""
    import copy

    import numpy as np

    from physicedit_torch.parallel.sharding import create_mesh

    pipe = copy.deepcopy(inputs["pipe"]).shard(create_mesh(1, world, "cpu"))
    out = {"single": np.asarray(pipe(inputs["prompt"], **inputs["single_kw"]))}
    pipe = copy.deepcopy(inputs["pipe"]).shard(create_mesh(2, world // 2, "cpu"))
    b = inputs["batch"]
    out["batch"] = [np.asarray(im) for im in pipe.edit_batch(b["prompts"], b["images"],
                                                             **b["kw"])]
    m = inputs["mixed"]
    out["mixed"] = [np.asarray(im) for im in pipe.edit_batch_mixed(m["prompts"], m["images"],
                                                                   **m["kw"])]
    out["reason"] = pipe.reason_physical_batch(b["prompts"], b["images"], max_new_tokens=6)
    return out


@case
def train(inputs, rank, world):
    """One train_step of a tensor-parallel (1, world) and of a
    data-parallel (world, 1) mesh: loss, the gradients it applied and the
    updated trainable surface."""
    from physicedit_torch.io.from_jax import dit_from_jax, to_jax_tree, trainable_from_jax
    from physicedit_torch.parallel import sharding as shd
    from physicedit_torch.train import train_step as ts
    from physicedit_torch.train.trainer import data_group, local_rows

    out = {}
    for name, shape in (("tp", (1, world)), ("dp", (world, 1))):
        mesh = shd.create_mesh(*shape, "cpu")
        dit = dit_from_jax(inputs["params"], inputs["cfg"], device="cpu")
        trainable = trainable_from_jax(inputs["trainable"], inputs["cfg"], device="cpu")
        shd.shard_params(dit, shd.dit_param_specs(dit), mesh)
        opt = ts.make_optimizer(inputs["lr"], 1e-2)
        metrics = ts.train_step(trainable, dit, opt, opt.init(trainable),
                                local_rows(inputs["batch"], mesh), inputs["t_min"],
                                inputs["t_max"], use_remat=True, grad_group=data_group(mesh))
        out[name] = {"loss": float(metrics["loss"]),
                     "grads": {"lora": to_jax_tree(trainable.lora, grads=True),
                               "adapters": to_jax_tree(trainable.adapters, grads=True)},
                     "params": {"lora": to_jax_tree(trainable.lora),
                                "adapters": to_jax_tree(trainable.adapters)}}
    return out


@case
def multihost(inputs, rank, world):
    """The multihost helpers on a (world / 2, 2) hybrid mesh."""
    import torch.distributed as dist

    from physicedit_torch.parallel import multihost as mh

    mh.initialize_distributed(device="cpu")     # already up: nothing happens
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    mesh = mh.create_hybrid_mesh(world // 2, 2, device="cpu")
    start, size = mh.host_local_batch_slice(8, mesh)
    rows = mh.global_batch_from_host_shards({"x": inputs["x"][start:start + size]}, mesh)
    return {"slice": (start, size), "x": rows["x"], "main": mh.is_main_process(),
            "model_ranks": dist.get_process_group_ranks(mesh.get_group("model"))}


@case
def train_cli(inputs, rank, world):
    """``cli.train.main`` with ``--data_parallel world --device cpu``, the
    tokenizer and the video reader stood in for as the tests do; returns
    the steps' losses."""
    import imageio

    from physicedit_torch.cli import train as t_cli
    from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline
    from physicedit_torch.pipeline.testing import FakeTokenizer
    from physicedit_torch.train import synthetic

    imageio.get_reader = synthetic.StandInReader
    load = PhysicEditPipeline.from_pretrained.__func__

    def from_pretrained(cls, *a, **kw):
        return load(cls, *a, **dict(kw, dtype=torch.float32))

    def load_tokenizer(pipe, path):
        pipe.tokenizer = FakeTokenizer()
        pipe.boi_token_id, pipe.eoi_token_id = 96, 95
        pipe.edit_drop_idx = pipe.t2i_drop_idx = 2

    PhysicEditPipeline.from_pretrained = classmethod(from_pretrained)
    PhysicEditPipeline.load_tokenizer = load_tokenizer
    trainer = t_cli.main(inputs["argv"])
    return {"loss": [h["loss"] for h in trainer.history], "step": trainer.global_step}


def main():
    import torch.distributed as dist

    job_path, rank = sys.argv[1], int(sys.argv[2])
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    world = job["world"]
    dist.init_process_group("gloo", store=dist.FileStore(job["store"], world), rank=rank,
                            world_size=world)
    try:
        result = CASES[job["case"]](job["inputs"], rank, world)
        assert "jax" not in sys.modules and "physicedit_tpu" not in sys.modules, \
            "a rank loaded JAX"
        torch.save(result, f"{job_path}.rank{rank}.pt")
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
