"""Datamodule registry: the ported datamodules, by the names the CLI's
``--data_module_name`` takes (the JAX package's names)."""
from typing import Dict

DATA_MODULES: Dict[str, type] = {}


def register_datamodule(name: str, cls: type) -> None:
    DATA_MODULES[name] = cls


def discover() -> Dict[str, type]:
    """Import the ported datamodule packages and register them. None of
    them imports pandas, h5py or yaml before it reads or writes data."""
    from .carla.carla_2d3d import Carla2D3DDataModule
    from .carla.carla_recorded import (CarlaBenchmarkDataModule,
                                       CarlaRecordedDataModule)
    from .openpose.datamodules import (JAADBenchmarkDataModule,
                                       JAADOpenPoseDataModule,
                                       PIEBenchmarkDataModule,
                                       PIEOpenPoseDataModule)
    register_datamodule("Carla2D3D", Carla2D3DDataModule)
    register_datamodule("CarlaRecorded", CarlaRecordedDataModule)
    register_datamodule("CarlaBenchmark", CarlaBenchmarkDataModule)
    register_datamodule("JAADOpenPose", JAADOpenPoseDataModule)
    register_datamodule("PIEOpenPose", PIEOpenPoseDataModule)
    register_datamodule("JAADBenchmark", JAADBenchmarkDataModule)
    register_datamodule("PIEBenchmark", PIEBenchmarkDataModule)
    return dict(DATA_MODULES)
