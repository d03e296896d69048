"""Song datasets and batch feeding."""

from .dataset import SegmentDataset, SongNpz, write_song_npz  # noqa: F401
from .loader import Batch, BatchLoader, DeviceFeeder, collate, decompress_batch, make_loaders  # noqa: F401
