"""Helpers for the parity tests between the JAX package and its PyTorch port.

Every parameter is drawn from a seeded numpy generator (a fresh init is
degenerate: zero MSDA offset kernels, 1e-6 injector gamma, unit BN stats),
handed to the JAX module as its variables and to the port through the
weight bridge (multimodal_sam_adapter_torch/engine/convert.py).
"""
import numpy as np
import torch


def randomize(tree, seed: int, std: float = 0.05):
    """A copy of a flax variables tree with every leaf drawn from
    N(0, std); BatchNorm variances become |N(0, std)| + 0.5."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        shape = np.shape(node)
        val = rng.standard_normal(shape).astype(np.float32) * std
        if path[-1] == "var":
            val = np.abs(val) + 0.5
        return val

    return walk(tree, ())


def load(module: torch.nn.Module, pairs, prefix: str = "m"):
    """Load bridge (key, array) pairs emitted under `prefix.` into a
    standalone port module, strictly; returns the module in eval mode."""
    sd = {}
    for k, v in pairs:
        assert k.startswith(prefix + "."), k
        sd[k[len(prefix) + 1:]] = torch.from_numpy(np.array(v, copy=True))
    module.load_state_dict(sd, strict=True)
    return module.eval()


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()
