from .unet import ConvBlock, StereoUNet, count_params

__all__ = ["ConvBlock", "StereoUNet", "count_params"]
