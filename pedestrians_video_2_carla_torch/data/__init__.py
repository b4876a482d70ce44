"""Datamodule registry: the ported datamodules, by the names the CLI's
``--data_module_name`` takes (the JAX package's names)."""
from typing import Dict

DATA_MODULES: Dict[str, type] = {}


def register_datamodule(name: str, cls: type) -> None:
    DATA_MODULES[name] = cls


def discover() -> Dict[str, type]:
    """Import the ported datamodule packages and register them. None of
    them imports pandas, h5py, yaml, scipy or cv2 before it reads or
    writes data."""
    from .carla.carla_2d3d import Carla2D3DDataModule
    from .carla.carla_recorded import (CarlaBenchmarkDataModule,
                                       CarlaRecordedDataModule,
                                       CarlaRecordedVideoDataModule)
    from .openpose.datamodules import (JAADBenchmarkDataModule,
                                       JAADOpenPoseDataModule,
                                       PIEBenchmarkDataModule,
                                       PIEOpenPoseDataModule)
    from .mixed.mixed import (CarlaRecAMASSDataModule,
                              JAADCarlaRecAMASSDataModule,
                              JAADCarlaRecBenchmarkDataModule,
                              JAADCarlaRecDataModule)
    from .mpii.mpii import MPIIDataModule
    from .smpl.amass import AMASSDataModule
    from .unipose.jaad_unipose import JAADUniPoseDataModule
    register_datamodule("Carla2D3D", Carla2D3DDataModule)
    register_datamodule("CarlaRecorded", CarlaRecordedDataModule)
    register_datamodule("CarlaBenchmark", CarlaBenchmarkDataModule)
    register_datamodule("CarlaRecordedVideo", CarlaRecordedVideoDataModule)
    register_datamodule("JAADOpenPose", JAADOpenPoseDataModule)
    register_datamodule("PIEOpenPose", PIEOpenPoseDataModule)
    register_datamodule("JAADBenchmark", JAADBenchmarkDataModule)
    register_datamodule("PIEBenchmark", PIEBenchmarkDataModule)
    register_datamodule("JAADUniPose", JAADUniPoseDataModule)
    register_datamodule("AMASS", AMASSDataModule)
    register_datamodule("MPII", MPIIDataModule)
    register_datamodule("JAADCarlaRec", JAADCarlaRecDataModule)
    register_datamodule("JAADCarlaRecAMASS", JAADCarlaRecAMASSDataModule)
    register_datamodule("CarlaRecAMASS", CarlaRecAMASSDataModule)
    register_datamodule("JAADCarlaRecBenchmark",
                        JAADCarlaRecBenchmarkDataModule)
    return dict(DATA_MODULES)
