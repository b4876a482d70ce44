"""Datamodule over an existing subsets directory (``--subsets_dir``): any
HDF5 subsets tree trains and evaluates, whichever datamodule, or package,
wrote it."""
import os

from .hdf5_datamodule import Hdf5DataModule


class SubsetsDataModule(Hdf5DataModule):
    """Loads ``{subsets_dir}/{train,val,test}.hdf5`` as they are."""

    def __init__(self, subsets_dir: str, **kwargs):
        if not subsets_dir:
            raise ValueError("SubsetsDataModule requires subsets_dir")
        super().__init__(subsets_dir=subsets_dir, **kwargs)

    def prepare_data(self) -> None:
        if os.path.exists(os.path.join(self._subsets_dir, "dparams.yaml")):
            self._load_set_info()
