"""Skeleton-enum factory: a skeleton is declared as a table of joint names
plus edge / hips / neck / colour / flip specs, and the factory builds the
``Skeleton`` IntEnum subclass with its classmethods wired up."""
from typing import Dict, Optional, Sequence, Tuple

from .base import Skeleton


def make_skeleton(name: str,
                  joints: Sequence[str],
                  edges: Sequence[Tuple[str, str]],
                  hips: Sequence[str],
                  neck: Sequence[str],
                  colors: Optional[Dict[str, Tuple[int, int, int, int]]] = None,
                  flip_map: Optional[Dict[str, str]] = None):
    """Build a Skeleton enum.

    :param flip_map: left<->right joint name pairs (either direction);
        joints not listed map to themselves.
    """
    cls = Skeleton(name, [(j, i) for i, j in enumerate(joints)])
    joint_list = list(joints)
    edge_pairs = [(cls[a], cls[b]) for (a, b) in edges]
    hips_members = [cls[h] for h in hips]
    neck_members = [cls[n] for n in neck]
    color_table = {cls[j]: (colors or {}).get(j, (0, 255, 0, 255))
                   for j in joints}

    flip = {}
    for a, b in (flip_map or {}).items():
        flip[a] = b
        flip[b] = a
    flip_mask = tuple(joint_list.index(flip.get(j, j)) for j in joint_list)

    cls.get_edges = classmethod(lambda c: list(edge_pairs))
    cls.get_colors = classmethod(lambda c: dict(color_table))
    cls.get_hips_point = classmethod(
        lambda c: hips_members[0] if len(hips_members) == 1
        else list(hips_members))
    cls.get_neck_point = classmethod(
        lambda c: neck_members[0] if len(neck_members) == 1
        else list(neck_members))
    cls.get_flip_mask = classmethod(lambda c: flip_mask)
    return cls


def lr_flip_map(joints: Sequence[str], left: str = "L",
                right: str = "R") -> Dict[str, str]:
    """Left<->right pairs from leading L/R characters (OpenPose-style
    names: LShoulder <-> RShoulder)."""
    out = {}
    for j in joints:
        if j.startswith(left) and (right + j[len(left):]) in joints:
            out[j] = right + j[len(left):]
    return out
