"""Skeleton registry and cross-skeleton joint mapping (the port's copy of
the JAX package's ``skeletons/base.py``, cut to what the ported slices
use). Mappings resolve to static numpy index arrays (or
``slice(None)``) that index tensors directly."""
from enum import IntEnum
from functools import lru_cache
from typing import Dict, List, Optional, Tuple, Type

import numpy as np


class Skeleton(IntEnum):
    """Base class for skeleton joint enums: members are joint names, values
    are tensor indices along the joint dimension."""

    @classmethod
    def get_colors(cls) -> Dict["Skeleton", Tuple[int, int, int, int]]:
        raise NotImplementedError()

    @classmethod
    def get_edges(cls) -> List[Tuple["Skeleton", "Skeleton"]]:
        raise NotImplementedError()

    @classmethod
    def get_flip_mask(cls) -> Tuple[int, ...]:
        """Joint permutation applied when the pose is mirrored left<->right."""
        raise NotImplementedError()

    @classmethod
    def get_edge_index(cls) -> np.ndarray:
        """Graph connectivity as a (2, 2*E) int array (both edge
        directions), for the dense-adjacency GNN layers."""
        edges = cls.get_edges()
        src = [a.value for (a, b) in edges] + [b.value for (a, b) in edges]
        dst = [b.value for (a, b) in edges] + [a.value for (a, b) in edges]
        return np.asarray([src, dst], dtype=np.int32)

    @classmethod
    def get_adjacency_matrix(cls, normalized: bool = True,
                             self_loops: bool = True) -> np.ndarray:
        """Dense (J, J) float32 adjacency, optionally with self loops and
        the symmetric normalization D^-1/2 A D^-1/2."""
        n = len(cls)
        adj = np.zeros((n, n), dtype=np.float32)
        ei = cls.get_edge_index()
        adj[ei[0], ei[1]] = 1.0
        if self_loops:
            adj = adj + np.eye(n, dtype=np.float32)
        if normalized:
            deg = adj.sum(axis=-1)
            d = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
            adj = adj * d[:, None] * d[None, :]
        return adj

    @classmethod
    def get_neck_point(cls) -> "Skeleton":
        raise NotImplementedError()

    @classmethod
    def get_hips_point(cls):
        """A single joint or a list of joints whose mean is the hips point."""
        raise NotImplementedError()

    @classmethod
    def get_hips_indices(cls) -> np.ndarray:
        hips = cls.get_hips_point()
        if isinstance(hips, (list, tuple)):
            return np.asarray([h.value for h in hips], dtype=np.int64)
        return np.asarray([hips.value], dtype=np.int64)

    @classmethod
    def get_neck_indices(cls) -> np.ndarray:
        neck = cls.get_neck_point()
        if isinstance(neck, (list, tuple)):
            return np.asarray([n.value for n in neck], dtype=np.int64)
        return np.asarray([neck.value], dtype=np.int64)


SKELETONS: Dict[str, Type[Skeleton]] = {}
#: skeleton class -> list of (CARLA_SKELETON member, skeleton member) pairs
MAPPINGS: Dict[Type[Skeleton], List[Tuple[Skeleton, Skeleton]]] = {}


def register_skeleton(name: str, skeleton: Type[Skeleton],
                      mapping: Optional[List[Tuple[Skeleton, Skeleton]]] = None):
    SKELETONS[name] = skeleton
    if mapping is not None:
        MAPPINGS[skeleton] = mapping


def get_skeleton_type_by_name(name: str) -> Type[Skeleton]:
    return SKELETONS[name]


def get_skeleton_name_by_type(skeleton: Type[Skeleton]) -> str:
    return skeleton.__name__


@lru_cache(maxsize=None)
def get_common_indices(input_nodes: Optional[Type[Skeleton]] = None,
                       output_nodes: Optional[Type[Skeleton]] = None):
    """Index pairs aligning two skeletons through CARLA_SKELETON as the pivot:
    ``(output_indices, input_indices)`` such that
    ``output_pose[..., output_indices, :]`` corresponds joint by joint to
    ``input_pose[..., input_indices, :]``."""
    if (input_nodes == output_nodes) \
            or (input_nodes is not None and input_nodes not in MAPPINGS) \
            or (output_nodes is not None and output_nodes not in MAPPINGS):
        return slice(None), slice(None)

    if input_nodes is not None:
        input_carla_indices, input_indices = zip(
            *[(c.value, o.value) for (c, o) in MAPPINGS[input_nodes]])
        if output_nodes is None:
            return (np.asarray(input_carla_indices, dtype=np.int64),
                    np.asarray(input_indices, dtype=np.int64))

    if output_nodes is not None:
        output_carla_indices, output_indices = zip(
            *[(c.value, o.value) for (c, o) in MAPPINGS[output_nodes]])
        if input_nodes is None:
            return (np.asarray(output_indices, dtype=np.int64),
                    np.asarray(output_carla_indices, dtype=np.int64))

    common = set(input_carla_indices).intersection(output_carla_indices)
    filtered_input = sorted(
        [(c, i) for (c, i) in zip(input_carla_indices, input_indices) if c in common])
    filtered_output = sorted(
        [(c, o) for (c, o) in zip(output_carla_indices, output_indices) if c in common])

    return (np.asarray([x[1] for x in filtered_output], dtype=np.int64),
            np.asarray([x[1] for x in filtered_input], dtype=np.int64))


def map_pose(pose: np.ndarray, data_nodes: Type[Skeleton],
             input_nodes: Type[Skeleton], num_input_joints: Optional[int] = None):
    """Remap a (..., J_data, C) numpy pose onto the ``input_nodes``
    skeleton, zero-filling joints without a correspondence."""
    if data_nodes == input_nodes:
        return pose
    out_idx, in_idx = get_common_indices(data_nodes, input_nodes)
    n_out = num_input_joints or len(input_nodes)
    out = np.zeros(pose.shape[:-2] + (n_out, pose.shape[-1]), dtype=pose.dtype)
    out[..., out_idx, :] = pose[..., in_idx, :]
    return out


def common_hips_index(input_nodes: Optional[Type[Skeleton]],
                      input_indices) -> Optional[int]:
    """Position of the hips joint within the common-joint axis produced by
    :func:`get_common_indices`; ``None`` when hips is a multi-joint point."""
    hips = input_nodes.get_hips_point()
    if isinstance(hips, (list, tuple)):
        return None
    if isinstance(input_indices, slice):
        return int(hips)
    idx = list(input_indices)
    return idx.index(int(hips)) if int(hips) in idx else None
