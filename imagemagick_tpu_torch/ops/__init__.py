"""The port's op families: resize, blur, colorspace, enhance (grayscale),
histogram, threshold, morphology, fourier, the fused pipelines and the
kernels."""
