"""The port's op families: resize, blur, colorspace, enhance (grayscale),
histogram, threshold, morphology, the fused pipelines and the kernels."""
