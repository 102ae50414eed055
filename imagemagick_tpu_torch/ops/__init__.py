"""The port's op families: every module of the JAX package's ``ops/``
(resize, blur, colorspace, enhance, histogram, threshold, morphology,
fourier, composite, statistic, transform, distort, shear, channel,
compare, fx, quantize, attribute, segment, feature, vision, paint, draw,
decorate, layer, montage and visual_effects), the fused pipelines and
the kernels."""
