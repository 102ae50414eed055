"""The port's op families (the slice: resize, blur, colorspace, fused)."""
