from magvit2_pytorch_tpu_torch.data.datasets import (
    DataLoader,
    ImageDataset,
    VideoDataset,
    collate_arrays_and_strings,
    cycle,
    normalize_u8,
    random_split,
)
from magvit2_pytorch_tpu_torch.data.video_io import (
    array_to_video,
    cast_num_frames,
    crop_center,
    gif_to_array,
    video_array_to_gif,
    video_tensor_to_gif,
    video_to_array,
)
