from vaegan_tpu_torch.data import nifti
from vaegan_tpu_torch.data.fetch import fetch_dataset
from vaegan_tpu_torch.data.pipeline import (
    CachedDataset,
    DataLoader,
    DeviceDataLoader,
    NiftiDataset,
    SyntheticDataset,
    device_prefetch,
    make_dataset,
    make_loader,
)

__all__ = [
    "nifti", "NiftiDataset", "SyntheticDataset", "CachedDataset", "DataLoader",
    "DeviceDataLoader", "device_prefetch", "fetch_dataset", "make_dataset", "make_loader",
]
