from .cache import load_cached_sample, sample_cache_relpath, save_cached_sample
from .dataset import StereoSampleLoader
from .samples import StereoSample, discover_samples, split_samples

__all__ = [
    "StereoSample",
    "discover_samples",
    "split_samples",
    "sample_cache_relpath",
    "load_cached_sample",
    "save_cached_sample",
    "StereoSampleLoader",
]
