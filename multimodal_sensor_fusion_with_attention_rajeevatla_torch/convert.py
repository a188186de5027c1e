"""Flax variables <-> ``state_dict`` of the port's ``MultimodalFusionModel``.

The flax tree of the reference's ``MultimodalFusionModel.init`` maps as:

    encoders_<m>/input_projection|projection      -> encoders.<m>.<same>
    encoders_<m>/layer<i>/<q|k|v|out>_proj        -> encoders.<m>.layers.<i>.<same>
    encoders_<m>/layer<i>/linear1|linear2         -> encoders.<m>.layers.<i>.<same>
    encoders_<m>/layer<i>/norm1|norm2             -> encoders.<m>.layers.<i>.<same>
    encoders_<m>/layer<i>/moe/<e>                 -> encoders.<m>.layers.<i>.moe.<e>
    encoders_<m>/conv<i>|bn<i>                    -> encoders.<m>.<same> (cnn)
    encoders_<m>/frame_processor|attention|proj_hidden|proj_out -> encoders.<m>.<same>
    encoders_<m>/dense<i>|bn<i>|out               -> encoders.<m>.<same> (mlp)
    ln_<m>                                        -> layer_norms.<m>
    [fusion_model/]proj_<m> | gate_<m>            -> [fusion_model.]projections.<m> | gates.<m>
    fusion_model/classifier_hidden|classifier_out -> fusion_model.<same>
    fusion_model/pairs/<x>_kernel|<x>_bias        -> fusion_model.pairs.<same>
    fusion_model/fc0|fc1|head                     -> fusion_model.<same> (early)
    fusion_model/cls_<m>_fc|cls_<m>_head|unc_<m>_head -> fusion_model.<same> (late, uncertainty)
    fusion_model/weight_logits                    -> fusion_model.weight_logits (late)
    grouped_transformer_enc/<p>/kernel|bias|scale -> grouped_tf_encoder.<p>_kernel|_bias|_scale
    grouped_transformer_enc/proj_kernel|proj_bias -> grouped_tf_encoder.<same>
    encoders_<m>/rnn/<w>_l<k>                     -> encoders.<m>.rnn.<same>
    encoders_<m>/pipeline/pipe_layers/<p>/<leaf>  -> encoders.<m>.pipeline.pipe_layers.<p>.<leaf>
    grouped_rnn/<w>_l<k>|proj_kernel|proj_bias    -> grouped_rnn_encoder.<same>

(``<e>`` is ``router``, ``moe_w1``, ``moe_b1``, ``moe_w2`` or ``moe_b2`` of an
MoE layer, kept in the reference's layout: ``[H, E]``, ``[E, H, F]``,
``[E, F]``, ``[E, F, H]``, ``[E, H]``.)

(``<p>/<leaf>`` of a pipelined encoder, ``parallel.pipeline_parallel`` > 1:
``q_proj`` ... ``linear2`` with ``kernel [L, in, out]`` and ``bias [L, out]``,
``norm1`` / ``norm2`` with ``scale`` and ``bias [L, H]``, kept as they are.)

(``<w>`` is ``weight_ih``, ``weight_hh``, ``bias_ih`` or ``bias_hh`` of an lstm
or gru encoder; recurrent weights keep the reference's ``[in, gates*H]`` layout,
stacked ``[G, in, gates*H]`` in the grouped encoder.)

(``<p>`` is ``input_projection``, ``{q,k,v,out}_proj_l<i>``, ``linear{1,2}_l<i>``
or ``norm{1,2}_l<i>`` of a model built with ``model.grouped_transformer``; its
stacked ``[G, in, out]`` kernels keep the reference's layout.)

A Dense ``kernel [in, out]`` becomes ``weight [out, in]``, a Conv ``kernel
[width, in, out]`` the ``Conv1d`` ``weight [out, in, width]``; a LayerNorm or
BatchNorm ``scale`` becomes ``weight``; the stacked pair kernels ``[P, H, H]``
keep the reference's ``[in, out]`` layout, which is how the port stores them.
The ``batch_stats`` collection's ``<path>/mean`` and ``<path>/var`` become the
BatchNorm buffers ``<path>.running_mean`` and ``<path>.running_var``. Inputs
are numpy arrays (``np.asarray`` of the jax arrays); this module needs no JAX.
``to_flax_tree`` is the reverse for the ``params`` collection: port tensors
(weights or their gradients) as a flax-layout tree of numpy arrays, so that
two trees compare leaf by leaf; ``to_flax_variables`` gives a model's
``params`` and, where it has BatchNorms, its ``batch_stats``.
``scatter_state_dict`` and ``gather_state_dict`` cut a whole ``state_dict``
into one rank's pieces and put the pieces of every rank back together
(``parallel.mesh.state_shardings``: the tensor-parallel feed-forward's
columns and rows, the experts, the pipeline's ``pipe_layers`` rows), so a
checkpoint is always the whole tree. ``ungroup_state_dict`` unstacks a grouped model's weights (transformer or
recurrent group) into the per-modality encoders of the ungrouped model, which
computes the same function.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Union

import numpy as np
import torch

from .parallel.mesh import Mesh, gather_full, local_slice, state_shardings


GROUPED_FLAX = "grouped_transformer_enc"
GROUPED_PORT = "grouped_tf_encoder"
GROUPED_RNN_FLAX = "grouped_rnn"
GROUPED_RNN_PORT = "grouped_rnn_encoder"
PIPE = "pipe_layers"


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            flat.update(_flatten(value, prefix + (str(key),)))
        else:
            flat[prefix + (str(key),)] = np.asarray(value)
    return flat


# batch_stats leaf -> BatchNorm buffer
_STATS = {"mean": "running_mean", "var": "running_var"}


def _module_path(path: tuple) -> list:
    out = []
    # the hybrid head's proj_<m> / gate_<m>; an encoder's own names (the
    # frame encoder's proj_hidden, proj_out) stay as they are
    in_encoder = bool(path) and path[0].startswith("encoders_")
    for i, part in enumerate(path):
        if i == 0 and part.startswith("encoders_"):
            out += ["encoders", part[len("encoders_"):]]
        elif i == 0 and part.startswith("ln_"):
            out += ["layer_norms", part[len("ln_"):]]
        elif part.startswith("proj_") and not in_encoder:
            out += ["projections", part[len("proj_"):]]
        elif part.startswith("gate_") and not in_encoder:
            out += ["gates", part[len("gate_"):]]
        elif re.fullmatch(r"layer\d+", part):
            out += ["layers", part[len("layer"):]]
        else:
            out.append(part)
    return out


def from_flax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Convert a flax ``{"params": ..., ["batch_stats": ...]}`` tree (numpy
    leaves) to a state_dict."""
    params = variables["params"] if "params" in variables else variables
    state: Dict[str, torch.Tensor] = {}
    for path, array in _flatten(variables.get("batch_stats", {})).items():
        *module, leaf = path
        if leaf not in _STATS:
            raise ValueError(f"unknown batch statistic {'/'.join(path)}")
        state[".".join([*_module_path(tuple(module)), _STATS[leaf]])] = torch.from_numpy(
            np.array(array, dtype=np.float32))
    for path, array in _flatten(params).items():
        *module, leaf = path
        if module and module[0] == GROUPED_FLAX:
            # stacked [G, in, out] / [G, out] tensors kept as they are
            state[".".join([GROUPED_PORT, "_".join([*module[1:], leaf])])] = torch.from_numpy(
                np.array(array, dtype=np.float32))
            continue
        if module == [GROUPED_RNN_FLAX]:
            module = [GROUPED_RNN_PORT]
        names = _module_path(tuple(module))
        if PIPE in module:
            # the stacked pipe_layers tree, leaf for leaf, [L, in, out] kernels as they are
            state[".".join([*names, leaf])] = torch.from_numpy(np.array(array, dtype=np.float32))
            continue
        if module and module[-1] in ("pairs", "rnn", "moe", GROUPED_RNN_PORT):
            # stacked [P, H, H] / [P, H], the recurrent and the expert tensors kept as they are
            names.append(leaf)
        elif leaf == "kernel":
            if array.ndim not in (2, 3):
                raise ValueError(f"unexpected kernel shape {array.shape} at {'/'.join(path)}")
            names.append("weight")
            array = array.T  # [in, out] -> [out, in]; a conv's [w, in, out] -> [out, in, w]
        elif leaf == "scale":
            names.append("weight")
        elif leaf in ("bias", "weight_logits"):
            names.append(leaf)
        else:
            raise ValueError(f"unknown parameter {'/'.join(path)}")
        state[".".join(names)] = torch.from_numpy(np.array(array, dtype=np.float32))
    return state


def _flax_path(name: str) -> list:
    parts = name.split(".")
    out = []
    i = 0
    while i < len(parts):
        part = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        if i == 0 and part == "encoders":
            out.append(f"encoders_{nxt}")
            i += 2
        elif i == 0 and part == "layer_norms":
            out.append(f"ln_{nxt}")
            i += 2
        elif part == "projections":
            out.append(f"proj_{nxt}")
            i += 2
        elif part == "gates":
            out.append(f"gate_{nxt}")
            i += 2
        elif part == "layers":
            out.append(f"layer{nxt}")
            i += 2
        else:
            out.append(part)
            i += 1
    return out


def to_flax_tree(
    source: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
) -> Dict[str, Dict]:
    """Port tensors -> the flax ``params`` tree layout, numpy leaves.

    ``source`` is a model (its parameters) or a name -> tensor mapping with
    the same names (for example each parameter's ``.grad``). A Linear
    ``weight [out, in]`` becomes ``kernel [in, out]``, a ``Conv1d`` ``weight
    [out, in, w]`` ``kernel [w, in, out]``, a LayerNorm or BatchNorm
    ``weight`` becomes ``scale``; the stacked pair tensors stay ``[P, H, H]``.
    BatchNorm buffers belong to ``batch_stats`` (``to_flax_variables``).
    """
    items = dict(source.named_parameters()) if isinstance(source, torch.nn.Module) else source
    tree: Dict[str, Dict] = {}
    for name, tensor in items.items():
        *module, leaf = _flax_path(name)
        if leaf in _STATS.values():
            continue
        array = tensor.detach().cpu().numpy()
        if module == [GROUPED_PORT]:
            module = [GROUPED_FLAX]
            if not leaf.startswith("proj_"):  # <p>_kernel -> <p>/kernel
                param, _, leaf = leaf.rpartition("_")
                module.append(param)
        elif module == [GROUPED_RNN_PORT]:
            module = [GROUPED_RNN_FLAX]
        elif module and (module[-1] in ("pairs", "rnn", "moe") or PIPE in module):
            pass  # stacked [P, H, H] / [P, H], the recurrent and the expert tensors kept as they are
        elif leaf == "weight" and array.ndim in (2, 3):
            leaf, array = "kernel", array.T
        elif leaf == "weight":
            leaf = "scale"
        node = tree
        for part in module:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(array)
    return tree


def to_flax_variables(model: torch.nn.Module) -> Dict[str, Dict]:
    """A model's ``{"params": ...}`` tree and, where it has BatchNorms, its
    ``{"batch_stats": {<path>: {"mean", "var"}}}``, numpy leaves."""
    variables = {"params": to_flax_tree(model)}
    names = {buffer: stat for stat, buffer in _STATS.items()}
    for name, tensor in model.named_buffers():
        *module, leaf = _flax_path(name)
        if leaf in names:
            node = variables.setdefault("batch_stats", {})
            for part in module:
                node = node.setdefault(part, {})
            node[names[leaf]] = tensor.detach().cpu().numpy().copy()
    return variables


def ungroup_state_dict(
    state: Mapping[str, torch.Tensor],
    names: Sequence[str],
    input_dims: Mapping[str, int],
    rnn_names: Sequence[str] = (),
) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a grouped model -> that of the ungrouped model
    carrying the same weights. ``names`` are the members of the transformer
    group (``model.grouped_tf_names``), ``rnn_names`` those of the recurrent
    group (``model.grouped_rnn_names``): member ``g`` of every stacked tensor
    becomes the tensor of ``encoders.<member g>`` (a dense kernel ``[in, out]``
    transposed to ``weight [out, in]``, recurrent weights as they are; the
    first layer's input weights cut back from the group's padded width to the
    member's own). Every other entry passes through."""
    out: Dict[str, torch.Tensor] = {}
    prefix, rnn_prefix = GROUPED_PORT + ".", GROUPED_RNN_PORT + "."
    for key, value in state.items():
        if key.startswith(rnn_prefix):
            param = key[len(rnn_prefix):]
            for g, name in enumerate(rnn_names):
                member = value[g]
                if param == "weight_ih_l0":
                    member = member[: int(input_dims[name])]
                if param == "proj_kernel":
                    out[f"encoders.{name}.projection.weight"] = member.t().contiguous()
                elif param == "proj_bias":
                    out[f"encoders.{name}.projection.bias"] = member.clone()
                else:
                    out[f"encoders.{name}.rnn.{param}"] = member.clone()
            continue
        if not key.startswith(prefix):
            out[key] = value
            continue
        param, _, leaf = key[len(prefix):].rpartition("_")
        if param == "input_projection":
            target = param
        elif param == "proj":
            target = "projection"
        else:
            base, _, layer = param.rpartition("_l")
            target = f"layers.{layer}.{base}"
        for g, name in enumerate(names):
            member = value[g]
            if param == "input_projection" and leaf == "kernel":
                member = member[: int(input_dims[name])]
            port_leaf = "bias" if leaf == "bias" else "weight"
            out[f"encoders.{name}.{target}.{port_leaf}"] = (
                member.t().contiguous() if leaf == "kernel" else member.clone()
            )
    return out


def _param_specs(state: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, tuple]:
    # a spec depends on the name and the rank of the tensor alone: the same
    # for a whole tensor and for its piece
    return {k: spec for k, (spec, _opt) in
            state_shardings(mesh, {k: tuple(v.shape) for k, v in state.items()}).items()}


def scatter_state_dict(state: Mapping[str, torch.Tensor], mesh: Mesh,
                       rank=None) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s pieces (this process's by default) of a whole
    ``state_dict``; buffers and replicated tensors as they are."""
    specs = _param_specs(state, mesh)
    return {k: local_slice(v, specs[k], mesh, rank) for k, v in state.items()}


def gather_state_dict(state: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The whole ``state_dict`` from every rank's pieces (collective: every
    rank of the mesh calls it)."""
    specs = _param_specs(state, mesh)
    return {k: gather_full(v, specs[k], mesh) for k, v in state.items()}
