"""RGB-D datasets: the on-disk loaders, their configs, a prefetcher and
the synthetic sequence (counterpart of ``splatam_tpu/data``)."""
from splatam_torch.data.base import RGBDDataset
from splatam_torch.data.dataconfig import load_dataset_config
from splatam_torch.data.datasets import (
    Ai2thorDataset,
    AzureKinectDataset,
    HabitatDataset,
    ICLDataset,
    NeRFCaptureDataset,
    Record3DDataset,
    RealsenseDataset,
    ReplicaDataset,
    ReplicaV2Dataset,
    ScannetDataset,
    ScannetPPDataset,
    TUMDataset,
    get_dataset,
)
from splatam_torch.data.prefetch import PrefetchLoader
from splatam_torch.data.synthetic import SyntheticDataset

__all__ = [
    "RGBDDataset",
    "load_dataset_config",
    "get_dataset",
    "PrefetchLoader",
    "SyntheticDataset",
    "ReplicaDataset",
    "ReplicaV2Dataset",
    "TUMDataset",
    "ScannetDataset",
    "ScannetPPDataset",
    "ICLDataset",
    "AzureKinectDataset",
    "Ai2thorDataset",
    "Record3DDataset",
    "RealsenseDataset",
    "NeRFCaptureDataset",
    "HabitatDataset",
]
