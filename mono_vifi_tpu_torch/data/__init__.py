"""Host-side data pipeline of the evaluation entry points (the port's copy
of the eval-mode parts of mono_vifi_tpu/data/): datasets that decode and
resize frames with PIL into NHWC float32 numpy arrays, and a threaded
prefetching loader that collates them into batches. PIL is imported where
an image is read, never at import time. The training pipeline (augmentation,
affine branch, samplers) is not ported yet."""

from mono_vifi_tpu_torch.data.cityscapes import CityscapesDataset
from mono_vifi_tpu_torch.data.kitti import KITTIRAWDataset
from mono_vifi_tpu_torch.data.loader import DataLoader
