"""Weight carry-over between the JAX package's parameter pytree and the
port's ``state_dict``.

The JAX pytree is ``{"gnn1": {"message": {"lin1": {"w": [in, out], "b"}, ...}}}``
(``w`` is ``[in, out]``); the port holds torch ``[out, in]`` under the
reference checkpoint names ``gnn{1,2}.<name>_mlp.{0,2}.{weight,bias}``.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict

import numpy as np
import torch

from pmhc_tpu_torch.models.score import ScoreNetwork, ScoreNetworkConfig

_log = logging.getLogger(__name__)

_MLP_NAMES = {
    "feature_mlp": "feature",
    "message_mlp": "message",
    "attention_mlp": "attention",
    "translation_mlp": "translation",
    "rotation_mlp": "rotation",
    "torsion_mlp": "torsion",
}
_SEQ = {"lin1": "0", "lin2": "2"}


def params_from_numpy(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX-layout numpy pytree -> the port's ``state_dict`` (CPU tensors)."""
    rev = {v: k for k, v in _MLP_NAMES.items()}
    state = {}
    for layer_name, layer in tree.items():
        for mlp_key, mlp in layer.items():
            for lin_key, lin in mlp.items():
                prefix = f"{layer_name}.{rev[mlp_key]}.{_SEQ[lin_key]}"
                w = np.array(np.asarray(lin["w"], np.float32).T, order="C")
                state[prefix + ".weight"] = torch.from_numpy(w)
                state[prefix + ".bias"] = torch.from_numpy(np.array(lin["b"], np.float32))
    return state


def params_to_numpy(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``state_dict`` -> JAX-layout numpy pytree."""
    lin_of = {v: k for k, v in _SEQ.items()}
    tree: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        layer_name, mlp_name, seq_idx, kind = key.split(".")
        value = tensor.detach().cpu().numpy().astype(np.float32)
        leaf = {"weight": ("w", value.T), "bias": ("b", value)}[kind]
        tree.setdefault(layer_name, {}).setdefault(_MLP_NAMES[mlp_name], {}).setdefault(
            lin_of[seq_idx], {})[leaf[0]] = np.ascontiguousarray(leaf[1])
    return tree


def load_checkpoint(path: str, config: ScoreNetworkConfig = ScoreNetworkConfig()) -> ScoreNetwork:
    """A reference-format ``.pth`` ``state_dict`` -> ``ScoreNetwork`` (CPU)."""
    model = ScoreNetwork(config)
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    return model


def load_params(model_path: str, architecture: str = "egnn") -> Dict[str, torch.Tensor]:
    """A ``state_dict``: from a reference-format ``.pth`` (strict), or the
    ``"model"`` of the latest step of a directory of the port's checkpoints
    (``train/checkpoints.py``). For the ``"structure"`` network, the
    ``.pth``'s ``state_dict`` as saved (``SamplerService`` loads it
    strictly)."""
    from pmhc_tpu_torch.train.checkpoints import CheckpointManager

    if os.path.isdir(model_path):
        manager = CheckpointManager(model_path)
        step = manager.latest_step()
        state = manager.restore(step)
        _log.info("restored checkpoint at step %s", step)
        return state["model"]
    if architecture == "structure":
        return torch.load(model_path, map_location="cpu", weights_only=True)
    return load_checkpoint(model_path).state_dict()
