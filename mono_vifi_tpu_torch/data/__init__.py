"""Host-side data pipeline (the port's copy of mono_vifi_tpu/data/ for KITTI
and Cityscapes): datasets that decode, augment and resize frames with PIL
into NHWC numpy arrays (training and evaluation), the stateful resumable
samplers, a threaded prefetching loader that collates batches, and
`device_prefetch`, which copies them to the card ahead of the step. PIL is
imported where an image is read, never at import time."""

from mono_vifi_tpu_torch.data.cityscapes import CityscapesDataset
from mono_vifi_tpu_torch.data.kitti import KITTIDepthDataset, KITTIOdomDataset, KITTIRAWDataset
from mono_vifi_tpu_torch.data.loader import DataLoader, device_prefetch
from mono_vifi_tpu_torch.data.samplers import StatefulDistributedSampler, StatefulSampler
