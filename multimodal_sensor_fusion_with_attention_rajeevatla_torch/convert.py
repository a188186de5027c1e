"""Flax variables -> ``state_dict`` of the port's ``MultimodalFusionModel``.

The flax tree of the reference's ``MultimodalFusionModel.init`` maps as:

    encoders_<m>/input_projection|projection      -> encoders.<m>.<same>
    encoders_<m>/layer<i>/<q|k|v|out>_proj        -> encoders.<m>.layers.<i>.<same>
    encoders_<m>/layer<i>/linear1|linear2         -> encoders.<m>.layers.<i>.<same>
    encoders_<m>/layer<i>/norm1|norm2             -> encoders.<m>.layers.<i>.<same>
    ln_<m>                                        -> layer_norms.<m>
    [fusion_model/]proj_<m> | gate_<m>            -> [fusion_model.]projections.<m> | gates.<m>
    fusion_model/classifier_hidden|classifier_out -> fusion_model.<same>
    fusion_model/pairs/<x>_kernel|<x>_bias        -> fusion_model.pairs.<same>

A Dense ``kernel [in, out]`` becomes ``weight [out, in]``; a LayerNorm
``scale`` becomes ``weight``; the stacked pair kernels ``[P, H, H]`` keep the
reference's ``[in, out]`` layout, which is how the port stores them. Inputs
are numpy arrays (``np.asarray`` of the jax arrays); this module needs no JAX.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            flat.update(_flatten(value, prefix + (str(key),)))
        else:
            flat[prefix + (str(key),)] = np.asarray(value)
    return flat


def _module_path(path: tuple) -> list:
    out = []
    for i, part in enumerate(path):
        if i == 0 and part.startswith("encoders_"):
            out += ["encoders", part[len("encoders_"):]]
        elif i == 0 and part.startswith("ln_"):
            out += ["layer_norms", part[len("ln_"):]]
        elif part.startswith("proj_"):
            out += ["projections", part[len("proj_"):]]
        elif part.startswith("gate_"):
            out += ["gates", part[len("gate_"):]]
        elif re.fullmatch(r"layer\d+", part):
            out += ["layers", part[len("layer"):]]
        else:
            out.append(part)
    return out


def from_flax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Convert a flax ``{"params": ...}`` tree (numpy leaves) to a state_dict."""
    params = variables["params"] if "params" in variables else variables
    state: Dict[str, torch.Tensor] = {}
    for path, array in _flatten(params).items():
        *module, leaf = path
        names = _module_path(tuple(module))
        if module and module[-1] == "pairs":
            names.append(leaf)  # stacked [P, H, H] / [P, H] kept as they are
        elif leaf == "kernel":
            if array.ndim != 2:
                raise ValueError(f"unexpected kernel shape {array.shape} at {'/'.join(path)}")
            names.append("weight")
            array = array.T
        elif leaf == "scale":
            names.append("weight")
        elif leaf == "bias":
            names.append("bias")
        else:
            raise ValueError(f"unknown parameter {'/'.join(path)}")
        state[".".join(names)] = torch.from_numpy(np.array(array, dtype=np.float32))
    return state
