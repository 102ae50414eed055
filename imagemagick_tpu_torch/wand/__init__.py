from .api import MagickWand, PixelWand, DrawingWand, new_magick_wand

__all__ = ["MagickWand", "PixelWand", "DrawingWand", "new_magick_wand"]
