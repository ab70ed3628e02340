"""The port does all the JAX package does, file by file: every module of
``physicedit_tpu/`` has a counterpart at the same path under
``physicedit_torch/``, and every extension loader the port names is its own.
Path names and one dict only; nothing of JAX is imported."""

import os

from physicedit_torch.io.safetensors_io import EXTENSION_LOADERS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX files whose counterpart has another shape, with where it lives
EXCEPTIONS = {
    "models/vae_init.py": "models/vae.py",   # the port's VAE module builds the same tree
    "lora/__init__.py": "lora.py",           # a package in JAX, one module in the port
}


def _modules(package: str) -> set:
    root = os.path.join(REPO, package)
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, files in os.walk(root) for f in files if f.endswith(".py")}


def test_every_jax_module_has_a_port_counterpart():
    jax_files, port_files = _modules("physicedit_tpu"), _modules("physicedit_torch")
    assert len(jax_files) > 80
    missing = sorted(f for f in jax_files - port_files if f not in EXCEPTIONS)
    assert not missing, f"no port counterpart for {missing}"
    for jax_file, port_file in EXCEPTIONS.items():
        assert jax_file in jax_files and port_file in port_files, (jax_file, port_file)


def test_extension_loaders_name_the_port():
    assert set(EXTENSION_LOADERS) == {"rife", "esrgan", "nexus_gen_llm"}
    for name, target in EXTENSION_LOADERS.items():
        assert target.startswith("physicedit_torch."), (name, target)
        module = target.rsplit(".", 1)[0].replace(".", os.sep) + ".py"
        assert os.path.isfile(os.path.join(REPO, module)), (name, module)
