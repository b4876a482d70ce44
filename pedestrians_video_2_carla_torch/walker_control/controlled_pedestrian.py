"""ControlledPedestrian: a reference pose to move, and optionally a live
CARLA walker bound to it, the system's last step: the walker driven with
the predicted bone rotations."""
import random
from typing import Dict

from ..skeletons.carla import CARLA_SKELETON
from . import carla_utils
from .carla_utils import (deepcopy_location, deepcopy_rotation,
                          deepcopy_transform, using_mock_carla)
from .pose import Pose, load_reference_pose_dict


class ControlledPedestrian:
    def __init__(self, world=None, age: str = "adult", gender: str = "female",
                 max_spawn_tries: int = 10, reference_pose=Pose, **kwargs):
        carla = carla_utils.carla
        self._age = age
        self._gender = gender

        pose_dict, root_hips_transform = load_reference_pose_dict(age, gender)
        if isinstance(reference_pose, Pose):
            self._current_pose = Pose()
            self._current_pose.relative = reference_pose.relative
        else:
            self._current_pose = reference_pose() \
                if isinstance(reference_pose, type) else reference_pose
            self._current_pose.relative = pose_dict
        self._root_hips_transform = root_hips_transform

        self._spawn_loc = carla.Location()
        self._world = None
        self._walker = None
        self._initial_transform = carla.Transform()
        self._world_transform = carla.Transform()
        self._max_spawn_tries = max_spawn_tries

        if world is not None:
            self.bind(world, True)

    # -- a live CARLA world ---------------------------------------------
    def bind(self, world, ignore_shift: bool = False):
        if using_mock_carla() \
                or getattr(carla_utils.carla, "World", None) is None:
            raise RuntimeError(
                "bind() needs a real CARLA installation; the mock carla "
                "shim cannot attach to a simulator world.")
        if not ignore_shift:
            shift = self.transform
        self._world = world
        self._walker = self._spawn_walker()
        self._initial_transform = self._walker.get_transform()
        self._world_transform = self._walker.get_transform()
        if not ignore_shift:
            self.teleport_by(shift)
        self._walker.set_simulate_physics(enabled=True)
        self.apply_pose(True)

    def _spawn_walker(self):
        blueprint_library = self._world.get_blueprint_library()
        matching = [bp for bp in blueprint_library.filter(
            "walker.pedestrian.*")
            if bp.get_attribute("age") == self._age
            and bp.get_attribute("gender") == self._gender]
        walker_bp = random.choice(matching)
        if walker_bp.has_attribute("is_invincible"):
            walker_bp.set_attribute("is_invincible", "false")
        walker = None
        tries = 0
        while walker is None and tries < self._max_spawn_tries:
            tries += 1
            loc = self._world.get_random_location_from_navigation()
            walker = self._world.try_spawn_actor(
                walker_bp, carla_utils.carla.Transform(loc))
        if walker is None:
            raise RuntimeError("Couldn't spawn walker")
        self._spawn_loc = loc
        self._world.tick()
        return walker

    # -- control ----------------------------------------------------------
    def teleport_by(self, transform, cue_tick: bool = False,
                    from_initial: bool = False) -> int:
        carla = carla_utils.carla
        ref = self.initial_transform if from_initial else self.world_transform
        self._world_transform = carla.Transform(
            location=carla.Location(
                x=ref.location.x + transform.location.x,
                y=ref.location.y + transform.location.y,
                z=ref.location.z + transform.location.z),
            rotation=carla.Rotation(
                pitch=ref.rotation.pitch + transform.rotation.pitch,
                yaw=ref.rotation.yaw + transform.rotation.yaw,
                roll=ref.rotation.roll + transform.rotation.roll))
        if self._walker is not None:
            self._walker.set_transform(self._world_transform)
            if cue_tick:
                return self._world.tick()
        return 0

    def update_pose(self, rotations: Dict[str, "carla.Rotation"],
                    cue_tick: bool = False) -> int:
        self._current_pose.move(rotations)
        return self.apply_pose(cue_tick)

    def apply_pose(self, cue_tick: bool = False, pose_snapshot=None,
                   root_hips_transform=None) -> int:
        """The current pose sent to the live walker through a
        ``WalkerBoneControlIn``, the hips at the root<->hips offset and the
        root at the origin with the root's rotation."""
        if self._walker is None:
            return 0
        carla = carla_utils.carla
        control = carla.WalkerBoneControlIn()
        if pose_snapshot is None:
            pose_snapshot = self._current_pose.relative
        if root_hips_transform is None:
            root_hips_transform = self._root_hips_transform

        hips = CARLA_SKELETON.crl_hips__C.name
        root = CARLA_SKELETON.crl_root.name
        pose_snapshot[hips] = carla.Transform(
            location=deepcopy_location(root_hips_transform.location),
            rotation=deepcopy_rotation(pose_snapshot[hips].rotation))
        pose_snapshot[root] = carla.Transform(
            location=carla.Location(),
            rotation=deepcopy_rotation(root_hips_transform.rotation))

        control.bone_transforms = list(pose_snapshot.items())
        self._walker.set_bones(control)
        self._walker.blend_pose(1)
        if cue_tick:
            return self._world.tick()
        return 0

    # -- properties -------------------------------------------------------
    @property
    def age(self) -> str:
        return self._age

    @property
    def gender(self) -> str:
        return self._gender

    @property
    def walker(self):
        return self._walker

    @property
    def current_pose(self) -> Pose:
        return self._current_pose

    @property
    def root_hips_transform(self):
        return deepcopy_transform(self._root_hips_transform)

    @property
    def world_transform(self):
        if self._walker is not None:
            return self._walker.get_transform()
        return self._world_transform

    @world_transform.setter
    def world_transform(self, transform):
        if self._walker is not None:
            self._walker.set_transform(transform)
        self._world_transform = transform

    @property
    def initial_transform(self):
        return deepcopy_transform(self._initial_transform)

    @property
    def transform(self):
        """The current world transform relative to the initial one."""
        carla = carla_utils.carla
        world = self.world_transform
        init = self._initial_transform
        return carla.Transform(
            location=carla.Location(
                x=world.location.x - init.location.x,
                y=world.location.y - init.location.y,
                z=world.location.z - init.location.z),
            rotation=carla.Rotation(
                pitch=world.rotation.pitch - init.rotation.pitch,
                yaw=world.rotation.yaw - init.rotation.yaw,
                roll=world.rotation.roll - init.rotation.roll))

    @property
    def spawn_shift(self):
        """The initial position less the spawn point."""
        return carla_utils.carla.Location(
            x=self._initial_transform.location.x - self._spawn_loc.x,
            y=self._initial_transform.location.y - self._spawn_loc.y,
            z=self._initial_transform.location.z - self._spawn_loc.z)
