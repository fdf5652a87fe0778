"""Host-side data pipeline (the port's copy of mono_vifi_tpu/data/): KITTI,
Cityscapes and NYUv2 datasets that decode, augment and resize frames with
PIL into NHWC numpy arrays (training and evaluation), the VFI triplet
datasets, the Make3D evaluation reader, the stateful resumable samplers, a
threaded prefetching loader that collates batches, and `device_prefetch`,
which copies them to the card ahead of the step. PIL, h5py, scipy and cv2
are imported where a file is read, never at import time."""

from mono_vifi_tpu_torch.data.cityscapes import CityscapesDataset
from mono_vifi_tpu_torch.data.kitti import KITTIDepthDataset, KITTIOdomDataset, KITTIRAWDataset
from mono_vifi_tpu_torch.data.loader import DataLoader, device_prefetch
from mono_vifi_tpu_torch.data.samplers import StatefulDistributedSampler, StatefulSampler
from mono_vifi_tpu_torch.data.make3d import Make3DDataset
from mono_vifi_tpu_torch.data.nyuv2 import NYUDataset
from mono_vifi_tpu_torch.data.vfi import CityscapesVFIDataset, KITTIVFIDataset
