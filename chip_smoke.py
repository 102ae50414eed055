#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives four BASELINE pipelines, each once through the port's two user
routes, and the port's three product surfaces (the thumbnailer, the CLI
and the serve daemon):

* config #1 — a batch of 32 NHWC float32 images of 512x768x3 -> Lanczos
  resize to 256x256 -> Gaussian blur sigma=2 -> sRGB->Gray.  The fused
  route, ``fused_resize_pipeline`` on the flat (N*H, W*C) wire layout,
  runs kernel K1 (``csrc/fused_pipeline.cu``); the op route,
  ``Image(batch).resize().gaussian_blur().transform_colorspace()``, runs
  kernel K3 (``csrc/separable_blur.cu``) for its blur.
* config #2 — a batch of 8 images of 1080x1920x3 -> Gaussian blur 0x2 ->
  unsharp 0x1 (gain 1, threshold 0) -> sRGB->Lab->sRGB.  The fused route,
  ``fused_blur_unsharp_pipeline``, runs kernel K2
  (``csrc/blur_unsharp.cu``); the op route, ``Image(batch)
  .gaussian_blur().unsharp_mask().transform_colorspace()`` twice, runs K3
  for both of its blurs; the pipelined fused route, the same call with
  ``pipelined=True``, runs kernel K2p (``csrc/blur_unsharp_pipe.cu``), K2's
  passes in a warp-specialised schedule on a persistent grid.
* config #3 — a batch of 16 letter pages of 1056x816x1 -> -auto-threshold
  otsu -> -morphology open square:1 -> -morphology close square:1 ->
  -edge 1.  Both routes take the per-image Otsu values from one launch of
  kernel K4 (``csrc/histogram256.cu``).  The fused route hands them to
  ``fused_bilevel_morph_edge``, kernel K5 (``csrc/morph_edge.cu``); the op
  route, ``models.pipelines.document_binarize()``, runs the threshold,
  the morphology and the edge as PyTorch ops.
* config #4 — a batch of one 2160x4096x1 frame -> forward 2-D DFT ->
  Wiener mask ``F*|F|^2 / (|F|^2 + 0.01*sum(x^2))`` -> inverse DFT ->
  clip.  The fused route, ``models.pipelines.fft_wiener()`` in the
  ``auto`` mode, runs kernels K6a -> K6b -> K6c (``csrc/wiener_fft.cu``;
  radix FFTs along W, down strips of columns, and along W again);
  the op route, the same pipeline under ``fourier.set_fft_mode("fft")``,
  runs ``torch.fft.rfft2`` -> mask -> ``irfft2``.
* config #5, the thumbnailer — ``models.thumbnailer.run`` over 64 JPEGs
  of 512x768 (quality 90, pixels from ``--seed``), batches of 16: each is
  decoded at 1/2 by the DCT-scaled decode into 256 rows of 1152 u8 lanes,
  uploaded, and resized to 256x256x3 by one K1 launch, then encoded.  The
  codec is the port's native one where it builds, else PIL's (the JAX
  function's fallback); the script says which.  Exactly 4 K1 launches in
  the timed run; the step's u8 output within 2 levels of the plain step's
  on the same staged bytes; every thumbnail decoded.
* config1_cli — 32 images of 512x768x3 on the card through the CLI's
  ``process(["-resize", "256x256!", "-gaussian-blur", "0x2",
  "-colorspace", "gray"])`` and ``materialize_all``: one K1 launch, no
  K3, >= 100 dB against float64, and the per-image marginal between 8 and
  32 images; then a chain that dispatch declines (8 images of 40x30x3) on
  K3 alone, against the same chain on the CPU.
* config1_serve — ``serve.make_server(port=0)`` on loopback: a session of
  64 u8 images of 512x768x3, the same chain applied with one K1 launch a
  request on the ``fused-batch`` path, alone and from 8 clients at once,
  and the fetched result within 1 level of the fused route's.
* cli_tone — the CLI's tone and threshold options: (a) 32 images of
  512x768x3 through ``-thumbnail 256x256 -auto-level -modulate 100,120
  -sigmoidal-contrast 3x50% -gamma 1.1`` (the thumbnail's resize for the
  group in one K1 launch, the rest image by image); (b) 16 color scans of
  1056x816 through ``-scale 50% -colorspace gray -normalize
  -auto-threshold otsu`` (one K1 and one K4 launch; the Otsu bins equal
  to the CPU run's, and every pixel that differs within 1e-4 of its
  threshold before it); (c) srgb -> key -> srgb for all 41 colorspaces on
  8 frames of 1080x1920x3, image 0 against the CPU; (d) ``-sample``,
  ``-adaptive-resize``, ``-magnify``, ``-ordered-dither``,
  ``-random-threshold`` (a binomial bound), ``-lat`` and the distance
  transform on 4 pages of 1056x816, each against its CPU run; the
  per-image marginals of (a) and (b) and the distance transform's time.
* effects, composite, cli_effects — blur's effects on 8 frames of 1080p,
  every composite operator on RGBA pairs, config #5 with a watermark and
  the CLI's effects chain, each against the CPU.
* transform — every function of ``ops/transform.py`` on 8 frames of
  1080x1920x3, required equal to the CPU, ms an image; trim on 4 pages.
* distort — rotate (30 degrees by EWA, RGB and RGBA, and 90 exact),
  every method of ``distort`` (+distort for srt, perspective and polar),
  swirl, implode, wave, the five sparse-color methods, shear 20x10 and
  deskew on 8 frames of 1080x1920x3, ms an image; frame 0 against the
  CPU within 1e-5 but at most 0.1 % of the pixels, where a selection
  falls otherwise (the per-pixel-EWA methods on a 270x480 frame, also
  with smaller EWA blocks, so that every scan of the timed call, one
  block, scanline blocks or pixel chunks, is compared on the card); the
  CUDA kernels of a polar and an arc call; liquid rescale of one 256x171
  image by 32 columns, its seams equal to the CPU's.
* cli_distort — config1_cli's 32 images through ``-resize 384x256 -flop
  -background white -rotate 12 -gravity center -extent 384x256 -distort
  Barrel "0.05 0.0 0.0" -bordercolor navy -border 4``: one K1 launch for
  the group's resize, every image against the CPU run, the per-image
  marginal between 8 and 32 images.
* cli_deskew — 16 letter pages of 1056x816x1, each rotated by a seeded
  angle in [-3, 3] degrees, through ``-deskew 40% -trim -shave 8x8``:
  each page's skew angle equal to the CPU's, the outputs against the
  CPU run, ms a page.
* fx — thirteen expressions (arithmetic, channel suffixes, ternaries,
  coordinates, two images, relative and absolute references, functions,
  variables, hue, luminance, transcendentals, rand) over 8 frames of
  1080x1920x3: ms an image, CUDA kernels a call, frame 0 against the CPU
  (at most 0.1 % of the pixels apart by 1e-5), rand by its moments.
* compare — every metric on a pair of 8 frames of 1080p against its
  formula in float64 numpy (1e-5 relative; phash on frame 0, ssim on one
  pair), compare_images and similarity_image (a 128x128 crop found at its
  offset), ms a call.
* quantize — the octree (native, on the host) with each dither and
  posterize 4 with each dither on 4 frames (host seconds a frame, equal
  to the CPU), kmeans_quantize 16 on 8 frames and kmeans_reference 8 on
  one (labels or pixels apart and the iterations against the CPU),
  unique_colors_count, image_type, image_depth, set_image_type.
* cli_channel — chain A (``-resize 256x256 -channel R -negate -channel
  All -channel-fx red<=>blue -alpha set -posterize 8 -type grayscale``)
  on config1_cli's 32 images, one K1 launch, and chain B's list ops
  (``-separate -combine -colors 64``, ``-fx (u+v)/2``, ``-metric rmse
  -compare``), one K1 launch a run; each against the CPU run (a chain
  with a native stage after the resize: its rest replayed on the CPU
  from the card's resize, equal), the per-image marginal of chain A.
* vision — on 8 frames of 1080x1920x3 (a mosaic of flat blocks, a
  shading and noise): Canny (its blur one K3 launch; the rest replayed on
  the CPU from the card's blur, equal; the whole CPU run's pixels apart
  counted), mean shift (a 270x480 crop of frame 0 equal to the CPU's),
  segment (frame 0 equal to the CPU's) and the GLCM (counts and metrics
  equal); on 16 binary letter pages of 1056x816x1, CCL at 4 and 8
  neighbours (two pages' labels equal to the CPU's), the merge of objects
  under 24 pixels (host), the area threshold and the Hough lines (page 0
  equal); ms an image each.
* draw — one MVG program of every primitive family (gradient, pattern,
  roundrectangle, circle, ellipse, arc, both fill rules, bezier, path,
  dashed polylines with each cap and join, a clip path, text) over 8
  frames of 1080p, frame 0 within 1e-6 of the CPU's float64 run; then
  annotate, frame, raise, oil paint (radius 3), opaque and transparent
  paint and the flood fill, frame 0 equal to the CPU's; the font used.
* cli_vision — 16 scanned pages through ``-auto-threshold otsu -define
  connected-components:area-threshold=24 -connected-components 8`` (one
  K4 launch; two pages equal to the CPU run) and 8 frames through
  ``-resize 50% -canny 0x1+10%+30% -hough-lines 9x9+150`` (one K1 launch,
  one K3 launch an image: the resize within K1's tolerance of the CPU's,
  Canny replayed from the card's blur and the lines from the card's edges
  equal, the whole CPU chain counted).
* cli_draw — 8 frames through ``-resize 50% -fill gold -stroke navy
  -strokewidth 3 -draw ... -pointsize 48 -annotate +20+60 ... -frame
  12x12+3+3`` (one K1 launch; the rest replayed on the CPU from the card's
  resize equal).
* visual_effects — every effect of ``ops/visual_effects.py`` on 8 frames
  of 1080x1920x3 (a photo editor's effects; shadow and polaroid on RGBA),
  ms an image: the seven noise types and the sketch on variates drawn on
  the card and handed to the CPU function; frame 0 against the CPU, or a
  540x960 crop of it where the CPU's run takes seconds (sketch,
  polaroid); one K3 launch for charcoal, shadow and polaroid each.
* layers — a GIF export: 24 frames of 512x768x4, a sprite moving over a
  still background (the first frame whole, each later one the changed box
  at its page offset, pauses that repeat a frame), through coalesce,
  optimize, optimize-transparency, remove-dups, deconstruct, flatten,
  mosaic, append and smush, ms a frame, each against the CPU run; and a
  contact sheet: ``montage`` of config1_cli's 32 images of 512x768x3 on an
  8x4 tile of 120x120+4+3, against the CPU.
* cli_layers — config1_cli's 32 images through three chains that start
  with ``-resize 50%`` (one K1 launch a group): a contact sheet (``-charcoal
  1 -tile 8x4 -montage``, one K3 launch an image), polaroids flattened onto
  a background (``-polaroid 5 -background white -flatten``, one K3 launch
  an image) and the options that need no file (``-morphology close disk:2
  -level-colors navy,gold -cdl ... -fft``): the resize within K1_TOL of the
  CPU's, the rest replayed on the CPU from the card's resize, ms an image.
* io — one 1080x1920x3 image from ``--seed``, encoded with PIL as PNG,
  JPEG and PPM and written as raw RGB samples: each decoded onto the card
  (``io.image_from_blob``, ``io.read_images`` with -size) equal bit for
  bit to the CPU's decode, and encoded from the card to the CPU's bytes;
  decode and encode ms an image.
* cli_files — 32 PNGs of 512x768x3 through config #1's chain to
  ``out-%d.png`` by ``cli.main.main(..., device="cuda")``: one K1 launch,
  the written samples within one level of the CPU run's on 99.9 % of
  them, images/s and the per-image marginal between 8 and 32 files; then
  16 PGM pages of 1056x816 through config #3's chain to PBM: one K4
  launch, the pages within 0.1 % of the CPU run's.
* serve_convert — ``serve.make_server(port=0)``: POST /convert of a
  1080x1920 JPEG with config #1's chain and ``of=jpeg``, one K1 launch a
  request, the result within one level of the CPU run's; the request
  wall beside its parts timed apart (host decode, upload, K1, download,
  host encode) and 8 clients at once; /identify and /formats.
* io_coders — the same 1080x1920x3 frame encoded on the CPU as MIFF (8
  and 16 bits, zip), MPC, EXR (half and float, zip), farbfeld and a
  16-bit Bayer DNG: each decoded onto the card equal bit for bit to its
  decode on the CPU (the DNG, whose demosaic runs on the card, within
  DNG_TOL; the demosaic alone within DNG_DEMOSAIC_TOL), and encoded from
  the card to the CPU's bytes, ms an image each; then ``cli.main.main``
  from MIFF files: 2 frames through ``-resize 50% -gaussian-blur 0x2
  -colorspace gray`` to EXR (one K1 launch, within EXR_HALF_TOL of the CPU
  run), 4 16-bit pages through ``-auto-threshold otsu`` to PBM (one K4
  launch, within 0.1 % of the CPU run's pixels), and a frame through
  ``-resize 50% -remap pal.png`` under Riemersma and FloydSteinberg (one
  K1 launch each; the written PNG equal to the remap replayed on the CPU
  from the card's resize).
* io_formats — the same kind of 1080x1920x3 frame encoded on the CPU as
  DPX (10 and 16 bits), FITS, AVS, MTV, FL32, VICAR, SUN, MAT, VIFF, RLA,
  Palm, PICT, PSD and PDF, its gray plane as WBMP, OTB, MONO, G3 and G4,
  and a 10-bit Cineon file, a 16-bit DICOM and a two-layer GIMP XCF built
  by hand: each decoded onto the card equal bit for bit to its decode on
  the CPU, and encoded from the card to the CPU's bytes (PSD and PDF,
  written only: the bytes), ms an image each; then ``cli.main.main``
  from their files: 2 10-bit DPX film frames through ``-resize 50%
  -gaussian-blur 0x2 -colorspace gray`` to DPX (one K1 launch, within
  one 10-bit code of the CPU run), 4 16-bit DICOM CT slices of 512x512
  through ``-auto-threshold otsu`` to PBM (one K4 launch; the pages equal
  to the CPU run's and thresholded at the float64 Otsu bin), and 2 G4
  fax pages of 2156x1728 through config #3's chain to G4 (one K4 launch,
  the bytes the CPU run's).
* io_formats4 — the same kind of frame encoded on the CPU as AAI, PGX (8
  and 16 bits), VIPS (8 and 16 bits), XWD, TIM, PDB, IPL, EPT, 16-bit
  TIFF (RGB and gray), YUV, Bayer (8 and 16 bits) and UYVY, its
  thresholded gray plane as CALS and ART: each decoded onto the card
  equal bit for bit to its decode on the CPU and encoded from the card
  to the CPU's bytes (YUV's and UYVY's, whose rgb_to_ycbcr runs on the
  card, within one level); HRZ's resize on the card (within one 6-bit
  code of the CPU's bytes), MAP's and WPG's 256-colour k-means on the
  card (the file decodes to its palette indexed by its labels; a
  270x480 crop's bytes the CPU's), an MVG program of about 20
  primitives drawn on a 1080x1920 canvas on the card (within draw's
  1e-6); the small, legacy and text formats at their own sizes (SCR,
  SCT, SFW, PWP, CUT, RLE, MAC, PIX, TIM2, JNX, PES, TTF, a 33-point
  CUBE, RGF, INLINE, TXT, FTXT, MAGICK decoded onto the card equal to
  the CPU's; CIP, UIL, HTML, CUR, ASHLAR, DCX and the braille variants
  encoded to the CPU's bytes) and a ``stegano:`` read of a watermark
  hidden on the card; then ``cli.main.main`` from their files: 2 48-bit
  TIFF frames through ``-resize 50% -gaussian-blur 0x2 -colorspace gray
  -depth 16`` to 16-bit TIFFs (one K1 launch, within 2 16-bit codes of
  the CPU run), a 48-bit frame graded through ``-hald-clut`` by a
  33-point ``.cube`` LUT from the seed (within one 16-bit code), and 2
  CALS pages of 2156x1728 through config #3's chain to CALS (one K4
  launch, the bytes the CPU run's, each page's Otsu value on the card
  the float64 bin).
* io_stream — the out-of-core tier: an 8-bit P6 scan of 8192x12288x3
  (100 megapixels, 1.2 GB as float32) from the seed through
  ``io.stream.convert_streaming`` in bands of 512 rows: (i) blur 0x2,
  level 5%,95% and unsharp 0x1 to a P6 (K3 once a band for each blur;
  the peaks of host memory, by tracemalloc, and of card memory, both
  below the image's float32 size), (ii) blur and level, a banded
  Lanczos resize to 4096x6144 and unsharp (K3 once an output band for
  each blur; within one 8-bit code of the in-core route on the card, and
  a strip of 1024 rows within STREAM_STRIP_TOL of the same ``run_chain``
  on the CPU); ``models.outofcore.reduce_tiled`` of ``channel_histogram``
  over ``io.stream.open_rows`` (K4 once a channel a band; the counts
  equal ``np.bincount`` of the file); a 16-bit MIFF of 1080x1920
  streamed through negate and level to PNG (8 and 16 bits) and MIFF on
  the card, within one code of the CPU run, and ``read_stream`` of a P6,
  a 16-bit and a float MIFF equal to ``read_images``; the last coders
  decoded onto the card and encoded from it against the CPU (HDR of
  values up to 16 in RGB and gray, WMF and EMF of about 30 records
  decoding to 1920x1080 within draw's 1e-6, the META profiles, DMR
  batches with and without a passphrase, STRIMG, MATTE, DEBUG, JBIG or
  its ValueError without libjbig, a ``file:`` URL); then
  ``cli.main.main`` over 4 EMF and 4 WMF files through ``-resize 50%
  -gaussian-blur 0x2 -colorspace gray`` (one K1 launch) and 4 PNG
  frames through the same chain into an enciphered ``dmr:`` repository
  and back (one K1 launch), each within one 8-bit code of the CPU run.
* cli_tools — the CLI's other tools through ``cli.main.main(...,
  device="cuda")``: mogrify ``-path -format png`` of 8 PNGs of 512x768x3
  through config #1's chain (K1 once a file, each output the bytes that
  convert writes for the file); composite of an RGBA overlay onto a
  1080p frame (``-gravity center -geometry +10+10``), a montage of 16
  tiles (``-tile 4x4 -geometry 256x256+4+4``) and an MSL script (read a
  1080p PNG, resize, blur, write) by conjure, each within one level of
  the CPU run; compare ``-metric`` rmse, psnr and ncc of two 1080p
  frames and ``-subimage-search`` of a 64x64 patch in 540x960 (the
  numbers within 1e-5 of the CPU run's, the exit codes and the offset
  equal); identify ``-format`` (the CPU's text); stream ``-extract
  1920x1080+0+0`` of a 3840x2160 PNG (the CPU's bytes); ``-region
  800x600+100+100 -gaussian-blur 0x2`` on a 1080p frame (one K3 launch,
  outside equal to the input, inside within EFFECT_TOL of the CPU);
  ``-bench 5`` of config #1's chain (its Performance line parsed, K1
  five times); display to a file and as sixel.  Then the palette walks
  (``csrc/palette_walk.cu``): each entry equal to its plain version bit
  for bit on 2 x 48x63 frames at C = 1, 3, 4 with 2, 16 and 256
  entries, inputs in [-0.3, 1.3]; ``remap(..., dither=True)`` of 4 x
  1080x1920x3 onto 16 and onto 256 entries (one Floyd-Steinberg launch
  each, timed; its first 8 rows equal the plain walk of the input's
  first 8 rows, and every pixel is a palette entry); Riemersma on 1 x
  256x256x3 equal to its plain version, timed.  The plain walks run on
  CPU copies (the same float32 operations); each walk's bound is its
  chain of H*W dependent steps, each at the SM cycles that
  ``pw_step_cycles`` measures for one step at its narrowest (a dependent
  shared-memory load and five shuffle levels) and the card's top SM clock
  (``nvidia-smi``), or its bytes or operations where larger.
* wand — the MagickWand API on the card: a 1080x1920x3 PPM read into a
  wand, ``resize_image(960, 540)`` and ``gaussian_blur_image(0, 2)``
  (one K1 launch each) and ``write_image`` to a 16-bit PPM, within K1's
  tolerance of the same chain on a ``device="cpu"`` wand; ``blur_image``
  of a frame with a non-opaque alpha (K3), ``auto_threshold_image`` of a
  page (one K4 launch) and ``remap_image`` of a batch under a dither (one
  Floyd-Steinberg walk launch), each against the CPU wand; a pixel round
  trip, ``draw_image``, a ``WandView`` update and a ``PixelIterator``
  sync on a clone (the original unchanged), and the top-level
  ``read``/``write``.
* magickpp_perl — the Magick++ layer and PerlMagick on the card.  The
  port's Magick++ library and four programs are built with g++ at once:
  ``tests/magickpp_demo.cpp`` for the card and for the CPU
  (``-DMAGICKPP_DEVICE="cpu"``), whose 80 ``key=value`` lines must be
  equal, and the phase's own C++ chain (``MAGICKPP_CHAIN``) for both: a
  1080x1920x3 PPM read into ``Magick::Image``, ``resize(960x540)`` and
  ``gaussianBlur(0, 2)`` (one K1 launch each) and a 16-bit PPM written,
  a 540x960 RGBA PNG with a non-opaque alpha blurred (K3) and a page's
  ``autoThreshold(Otsu)`` (K4).  The program sets the launch counts to 0
  and reads them in its own embedded interpreter around each call; the
  card's pixels are held to the CPU build's within K1's and K3's
  tolerances, Otsu equal, the written samples within one level.  A Perl
  script (Read, Resize, Blur, Write of the same PPM) runs through the
  port's ``Image::Magick`` with ``$Image::Magick::Device`` 'cuda' and
  'cpu', its samples within one level; the same JSON requests go to
  ``rpc_server.serve`` in this process on the card, which counts their
  launches (K1 twice) and writes the Perl run's file.  Each run's wall
  and each chain's ms are printed.
* parallel — ``parallel/`` and ``models/gigapixel.py``, each mesh one
  card named several times: config #2's batch on a 2x2x2 mesh through
  the sharded blur (K3 once a block), histograms (K4 once a block),
  statistics, resize, open, median and Otsu (K4 once a block), each held
  to the unsharded op; K1 on each block of a dp = 4 mesh (config #1's
  batch); ``process_gigapixel`` of one 32768x32768x3 image on a 1x2x2
  mesh (K3 once a block), its seams and borders held to the unsharded
  math and its statistics to float64, with its time, MP/s and peak card
  memory; the CLI's ``-define tpu:mesh``; an NCCL group of one through
  ``init_distributed``; ``dryrun_multichip(8)``.

It builds the kernels from the sources in the checkout and holds each
against its plain PyTorch version on the card, at the main paths' shapes
and at shapes that do not fill a tile (K2 also at 1 + 1 and 33 + 17 taps,
on 32- and 16-tiles; K4 also at rows that do not start on a 16-byte
boundary, one row of 2^24 + 5 values, 1024 short rows, a 90 %-white and
a near-white page, and to one CUDA kernel a call by ``torch.profiler``),
and K2p to K2 on every value at six shapes.  Each
main path runs with every launch count set to 0 just before it and read
just after.  It checks the
fused routes of configs #1 and #2 against a float64 reference (>= 100 dB)
and each pair of routes against each other (>= 60 dB; an op route clips
after every op); config #3's results are exact 0/1 images, so K4, K5 and
the two routes are held to equality, every image's Otsu bin to a float64
numpy Otsu, and image 0 to a numpy op chain; config #4's fused route is
held to a float64 numpy Wiener (>= 100 dB) and to the op route (>= 100
dB: neither clips before its end); K6a and K6c are also held at
(1, 7, 8192) and (1, 5, 8186), and K6c on a non-Hermitian spectrum
against a float64 inverse.  It then times each kernel against its plain
version and each route end to end with CUDA events: per call
(``median_ms``: one event pair around one call on an idle stream, median
of 25 after a warm-up, so host work and launch latency are included) and,
for each kernel and its library call, device-only (``device_ms``: one
event pair around 20 back-to-back calls, over 20, median of 5); K3 also
at config #2's two op-route shapes; K4, whose wrapper's host work is
longer than its kernel, also on the profiler's clock (``kernel_ms``).  It computes each kernel's bound: the
larger of its bytes over 3.35 TB/s and its float32 operations over 67
TFLOP/s, the H100 SXM's published peaks.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.  It
needs one CUDA card and fails without one.  The line before the last is
a JSON object with every kernel's launches on the main path, its largest
error against the plain version, its times (per call and device-only)
and its bound (the palette walks' rows also name their shapes and the
plain walk's, which runs on the host); before it, the run's total on
the host clock; the last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
import contextlib
import io
import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import time

import numpy as np
import torch

N, H, W, C = 32, 512, 768, 3
HOUT = WOUT = 256
SIGMA = 2.0
GRAY = np.array([[0.212656, 0.715158, 0.072186]])
TAGS = [("resize", (HOUT, WOUT, "lanczos")), ("gblur", (0.0, SIGMA, "2d")),
        ("mix", ((0.212656, 0.715158, 0.072186),))]
RUNS = 25
DEVICE_LAUNCHES = 20   # back-to-back calls in one device_ms run
DEVICE_RUNS = 5
K3_TOL = 1e-5   # float32 sums of <= 33 taps in another order
K1_TOL = 2e-5   # float32 dot products over the operators' windows (about
                # 237 input lanes a row at config #1) in another order than
                # torch.matmul's
# config #2
N2, H2, W2 = 8, 1080, 1920
SIGMA_UNSHARP = 1.0
GAIN = 1.0
K2_TOL = 2e-5      # float32 sums of 15 + 9 taps in another order
K2_LAB_TOL = 5e-5  # and powf / cbrtf against torch.pow
# config #3
N3, H3, W3 = 16, 1056, 816
# K5 beside config #3: words of 32 pixels, a row cut into groups of 30
# words past 1024 pixels, images shorter than a strip's 5-row halo
K5_SHAPES = ((2, 77, 61), (1, 1, 50), (1, 5, 1), (3, 40, 700), (2, 9, 31),
             (2, 9, 32), (2, 9, 33), (1, 23, 1025)) + tuple(
                 (2, h, 37) for h in (1, 2, 3, 4, 5, 6, 11))
# config #5 (the thumbnailer's step): a batch of 16 of config #1's images
# -> Lanczos to 256x256x3, no blur, identity mix
N5 = 16
THUMB = 256
# config #5 end to end (benchmarks.py:549-606): 64 JPEGs of 512x768,
# quality 90, in batches of 16; the DCT-scaled decode stages each at 1/2
# (384x256x3: 256 rows of 1152 lanes)
CORPUS5 = 64
STAGED5 = (256, 1152)
THUMB_LEVELS = 2    # u8 levels between the card's step and the plain step
# config1_cli (benchmarks.py:168-219) and config1_serve (:222-)
CLI_ARGV = ["-resize", "256x256!", "-gaussian-blur", "0x2", "-colorspace",
            "gray"]
CLI_N1, CLI_N2 = 8, 32
CLI_SMALL = (8, 40, 30, 3)   # W * C < 128: dispatch declines the chain
CLI_OP_TOL = 2e-5   # the op chain on the card against the same chain on
                    # the CPU: float32 resize products and K3's sums in
                    # another order
SERVE_N = 64
SERVE_APPLIES = 5
SERVE_CLIENTS, SERVE_ROUNDS = 8, 3
# cli_tone: (a) the thumbnail chain on config1_cli's images, (b) the
# document chain on config #3's letter pages scanned in color, (c) every
# colorspace round trip on config #2's frames, (d) the other ops of the
# slice on config #3's page size
TONE_A = ["-thumbnail", "256x256", "-auto-level", "-modulate", "100,120",
          "-sigmoidal-contrast", "3x50%", "-gamma", "1.1"]
TONE_A_N1, TONE_A_N2 = 8, 32
TONE_A_TOL = 1e-4   # K1's 2e-5 through auto-level's stretch, the hue of
                    # near-gray pixels, and the card's expf/powf against
                    # the CPU's (a few ulps) through the sigmoid and gamma
TONE_B = ["-scale", "50%", "-colorspace", "gray", "-normalize",
          "-auto-threshold", "otsu"]
TONE_B_N1, TONE_B_N2 = 4, 16
TONE_B_TOL = 1e-4   # K1's 2e-5 through normalize's stretch, and a shift
                    # of its 65536-bin levels by one bin (1.5e-5)
ROUNDTRIP_N = 8
ROUNDTRIP_TOL = 5e-5   # the card's float32 pow, exp, log, atan2 and
                       # sin/cos round otherwise than the CPU's by a few
                       # ulps, and the inverse sRGB transfer's slope (up
                       # to 12.92) amplifies them
ROUNDTRIP_F64 = 3.0    # and at least this many times the CPU's own
                       # float32 error against float64 on the same
                       # image: |card - cpu| <= |card - f64| + |cpu - f64|,
                       # with the card's functions up to twice the CPU's
                       # ulps.  That is what the ill-conditioned trips
                       # reach: Jzazbz inverts its PQ curve (powers 134
                       # and 6.28 of a difference near 0), PhotoYCC reads
                       # its ramp at round(1024*v) (one step 7.2e-4)
TONE_D_N = 4
TONE_D = [["-sample", "50%"], ["-adaptive-resize", "75%"], ["-magnify"],
          ["-ordered-dither", "o8x8"], ["-random-threshold", "20x80%"],
          ["-lat", "15x15-5%"]]
TONE_D_TOL = {"-adaptive-resize": 1e-6}   # mesh weights: float32 sums of
                                          # three products; the rest equal
LAT_TOL = 2e-5      # cuDNN's float32 mean of 225 taps in another order
# effects: every effect of ops/blur.py's slice on config #2's frames
EFFECTS = [("sharpen", (0.0, 1.0)), ("adaptive_blur", (0.0, 2.0)),
           ("adaptive_sharpen", (0.0, 2.0)), ("emboss", (1.0, 1.0)),
           ("motion_blur", (0.0, 3.0, 45.0)), ("rotational_blur", (10.0,)),
           ("selective_blur", (0.0, 1.0)), ("despeckle", ()),
           ("spread", (2.0,)), ("shade", (30.0, 30.0)),
           ("kuwahara", (3.0,)), ("bilateral_blur", (5, 5)),
           ("local_contrast", ())]
EFFECT_K3 = ("adaptive_blur", "adaptive_sharpen", "kuwahara")  # one each
EFFECT_TOL = 1e-5   # K3's and cuDNN's float32 sums in another order
# effects that select per pixel from values computed on each device (the
# adaptive level, the bilateral intensity byte, Kuwahara's quadrant, a
# rotational sample): pixels where the card selects otherwise are
# counted, at most this share of the pixels
EFFECT_SELECTS = ("adaptive_blur", "adaptive_sharpen", "bilateral_blur",
                  "kuwahara", "rotational_blur")
SELECT_SHARE = 1e-3
EFFECT_RUNS = 3
# composite: every operator on a pair of RGBA frames of config #2's size
COMPOSITE_N = 2
COMPOSITE_TOL = 1e-4    # the card's cosf, sqrtf and divisions, and the
                        # HCL round trip's, against the CPU's
COMPOSITE_ARGS = {"dissolve": (35.0,), "blend": (35.0,),
                  "mathematics": (0.5, 0.25, -0.3, 0.1),
                  "modulate": (60.0, 80.0), "displace": (10.0, 5.0)}
# config #5 with a watermark: a 64x64 RGBA PNG dissolved at 35 % in the
# southeast corner of every thumbnail
WATERMARK = 64
# cli_effects: config1_cli's images through blur's effects and a median,
# then two of them composited
CLI_EFFECTS = ["-resize", "256x256", "-sharpen", "0x1", "-adaptive-blur",
               "0x2", "-median", "1"]
CLI_COMPOSE = ["-gravity", "southeast", "-compose", "dissolve", "-define",
               "compose:args=35", "-composite"]
CLI_EFFECTS_N1, CLI_EFFECTS_N2 = 8, 32
# transform, distort, cli_distort, cli_deskew (config #2's frames,
# config1_cli's images, config #3's pages)
DISTORT_TOL = 1e-5      # float32 sums of EWA taps in another order, an ulp
#                         of the card's sinf/cosf/powf under a bilinear blend
DISTORT_RUNS = 3
DISTORT_EWA_RUNS = 1    # timed calls of a per-pixel-EWA method (0.5-1.8 s
                        # each: one keeps the script within its time)
DISTORT_SMALL = (270, 480)   # per-pixel-EWA methods compared at this size
# ... with these _EWA_BLOCKs too (None: the module's), so that the small
# frame's buckets take the pixel chunks and scanline blocks that the
# timed 8 x 1080p call takes
DISTORT_BLOCKS = (None, 1 << 22, 1 << 19)
LIQUID = (171, 256, 32)      # one image of 256x171, 32 columns removed
CLI_DISTORT = ["-resize", "384x256", "-flop", "-background", "white",
               "-rotate", "12", "-gravity", "center", "-extent", "384x256",
               "-distort", "Barrel", "0.05 0.0 0.0", "-bordercolor", "navy",
               "-border", "4"]
CLI_DISTORT_N1, CLI_DISTORT_N2 = 8, 32
CLI_DISTORT_ROUNDS = 1  # rounds of its marginal (55 ms an image)
CLI_DESKEW = ["-deskew", "40%", "-trim", "-shave", "8x8"]
DESKEW_N, DESKEW_MAX = 16, 3.0
# fx: one expression of each kind that tests/test_analysis_ops.py covers,
# an absolute reference, hue, luminance, transcendentals and rand
FX_EXPRS = [("arithmetic", "u/2+0.25"), ("channel suffix", "u.g"),
            ("ternary", "u>0.5?1.0:0.0"), ("coordinates", "i/w+j/h"),
            ("two images", "(u+v)/2"), ("relative ref", "p[1,0]"),
            ("functions", "sqrt(u)*sin(pi/2)"), ("variables", "t=u*2; t-u"),
            ("absolute ref", "p{i/2,j/2}"), ("hue", "hue"),
            ("luminance", "luminance"),
            ("transcendentals", "pow(u,2.2)*exp(-v)+erf(u-0.5)+sinc(v)"),
            ("rand", "rand()")]
FX_TOL = 1e-5           # the card's float32 transcendentals, an ulp apart
COMPARE_REL = 1e-5      # a float32 metric against its float64 formula
SSIM_FRAMES = 1         # pairs that ssim's float64 numpy reference covers
CLI_CHANNEL_ROUNDS = 1  # rounds of chain A's marginal (80 ms an image)
CLI_CALL_RUNS = 1       # timed calls of cli_vision's and cli_draw's frame
                        # chains, after a warm-up (1.3-1.6 s a call)
QUANT_N = 2             # frames of 1080p for the octree and posterize
CLI_CHANNEL_A = ["-resize", "256x256", "-channel", "R", "-negate",
                 "-channel", "All", "-channel-fx", "red<=>blue", "-alpha",
                 "set", "-posterize", "8", "-type", "grayscale"]
CLI_CHANNEL_B = [(["-resize", "256x256", "-separate", "-combine", "-colors",
                   "64"], 1),
                 (["-resize", "256x256", "-fx", "(u+v)/2"], 2),
                 (["-resize", "256x256", "-metric", "rmse", "-compare"], 2)]
CLI_CHANNEL_N1, CLI_CHANNEL_N2 = 8, 32
# segment, feature, vision, paint, draw and decorate
MS_CROP = (270, 480)    # mean shift held to the CPU on this crop of frame 0
CCL_CPU_PAGES = 2       # pages whose labels the CPU run reproduces
SPECKS = 0.002          # share of a page's pixels flipped into specks
AREA_MIN = 24           # connected-components:area-threshold
PAGE_HOUGH = (9, 9, 0)  # -hough-lines WxH+0 on the pages (threshold H/4)
FUZZ = 0.2              # the paint functions' fuzz
DRAW_TOL = 1e-6         # draw's float64 coverage blended in float32
# one MVG program of every primitive family at 1080p
MVG_1080 = (
    "push defs "
    "push gradient sky linear 0,0 1919,0 stop-color '#2050a0' 0 "
    "stop-color '#f0c060' 1 pop gradient "
    "push pattern checks 0 0 40 40 fill white rectangle 0,0 19,19 "
    "fill gray30 rectangle 20,20 39,39 pop pattern "
    "push clip-path lens circle 1500,820 1500,1000 pop clip-path pop defs "
    "fill 'url(#sky)' rectangle 40,40 900,300 "
    "fill 'url(#checks)' stroke black stroke-width 2 "
    "roundrectangle 960,40 1880,300 40,30 "
    "fill tomato stroke navy stroke-width 4 circle 250,520 250,680 "
    "fill gold stroke black stroke-width 3 ellipse 700,520 200,110 0,360 "
    "fill none stroke darkgreen stroke-width 6 arc 950,380 1350,660 20,300 "
    "fill-rule nonzero fill purple stroke none "
    "polygon 1500,340 1620,700 1380,460 1640,460 1420,700 "
    "fill-rule evenodd fill teal "
    "polygon 1760,340 1880,700 1640,460 1900,460 1680,700 "
    "fill none stroke maroon stroke-width 5 "
    "bezier 60,1000 300,700 600,1050 900,760 "
    "fill orange stroke black stroke-width 2 path 'M 100 760 C 200 720 300 "
    "720 400 780 S 500 900 380 960 Q 250 1000 180 900 T 100 760 Z' "
    "fill none stroke blue stroke-width 8 stroke-dasharray 30 12 "
    "stroke-linecap butt stroke-linejoin miter "
    "polyline 1000,760 1100,880 1200,770 1300,900 "
    "stroke red stroke-linecap round stroke-linejoin round "
    "polyline 1000,960 1100,1040 1200,960 1300,1050 "
    "stroke green stroke-linecap square stroke-linejoin bevel "
    "polyline 1000,1060 1100,1000 1200,1070 1300,1010 "
    "stroke-dasharray none push graphic-context clip-path url(#lens) "
    "fill white stroke none rectangle 1300,620 1700,1020 fill black "
    "font-size 64 text 1330,850 'clip' pop graphic-context "
    "fill black stroke none font-size 48 text 60,1060 'draw 1080p'")
CLI_VISION_PAGES = ["-auto-threshold", "otsu", "-define",
                    f"connected-components:area-threshold={AREA_MIN}",
                    "-connected-components", "8"]
CLI_VISION_FRAMES = ["-resize", "50%", "-canny", "0x1+10%+30%",
                     "-hough-lines", "9x9+150"]
CLI_DRAW = ["-resize", "50%", "-fill", "gold", "-stroke", "navy",
            "-strokewidth", "3", "-draw",
            "circle 240,135 240,215 polygon 500,40 700,240 420,200",
            "-pointsize", "48", "-annotate", "+20+60", "imagemagick",
            "-frame", "12x12+3+3"]
# visual_effects: the CPU holds frame 0, or this crop of it where its run
# takes seconds (sketch's 2160x3840 noise, polaroid's rotations)
VFX_CROP = (540, 960)
VFX_TOL = 1e-5     # float32 blurs, normalizations and resamples on the
                   # card against the CPU: sums in another order, an ulp
VFX_RUNS = 3
NOISE_TYPES = ("uniform", "gaussian", "impulse", "laplacian",
               "multiplicative", "poisson", "random")
VFX_K3 = ("charcoal", "shadow", "polaroid")   # one K3 launch a call each
VFX_EXACT = ("solarize", "stegano", "stereo")  # selections and copies
# layers: a GIF export of LAYER_N frames of H x W x 4, a SPRITE moving over
# a still background, pausing at LAYER_PAUSES (a repeated frame each)
LAYER_N = 24
SPRITE = (96, 128)
LAYER_PAUSES = (8, 9, 16)
LAYER_DELAY = 4      # 1/100 s a frame; the frames after a pause: 0
MONTAGE_TILE, MONTAGE_GEOMETRY = "8x4", "120x120+4+3"
# cli_layers: config1_cli's images through chains that start with a resize
CLI_LAYERS = [
    (["-resize", "50%", "-charcoal", "1", "-tile", "8x4", "-montage"], 1),
    (["-resize", "50%", "-polaroid", "5", "-background", "white",
      "-flatten"], 1),
    (["-resize", "50%", "-morphology", "close", "disk:2", "-level-colors",
      "navy,gold", "-cdl", "1.1,0.05,0.9:0.8", "-fft"], 0)]
# io, cli_files, serve_convert: files in and out on the card
IO_H, IO_W = 1080, 1920
IO_RUNS = 2            # timed runs of each part (median)
CLI_FILES_N1, CLI_FILES_N = 8, 32
CLI_FILES_ROUNDS = 1   # rounds of the 8-to-32-file marginal
CLI_FILES_PAGES = 16
CLI_PAGES = ["-auto-threshold", "otsu", "-morphology", "open", "square:1",
             "-morphology", "close", "square:1", "-edge", "1"]
SERVE_CONVERT_REQUESTS = 5
SERVE_CONVERT_ROUNDS = 2   # rounds of SERVE_CLIENTS requests at once
# io_coders: the second slice's coders and MIFF files through the CLI
CODER_RUNS = 1         # timed runs of each decode and encode, after a
                       # warm-up
CODER_FRAMES = 2       # 1080p MIFF frames through CLI_CODERS
CODER_PAGES = 4        # 16-bit MIFF pages of H3 x W3 through -auto-threshold
CLI_CODERS = ["-resize", "50%", "-gaussian-blur", "0x2", "-colorspace",
              "gray"]
EXR_HALF_TOL = 1e-3    # K1's 2e-5 can move a half float an ulp: 4.9e-4
                       # in [0.5, 1)
DNG_DEMOSAIC_TOL = 1e-6   # cuDNN's and the CPU's float32 sums of <= 9 taps
DNG_TOL = 2e-5         # that, times the sRGB transfer's slope (at most
                       # 12.92), and the card's pow an ulp from the CPU's
REMAP_PALETTE = [[0, 0, 0], [255, 255, 255], [200, 40, 40], [30, 90, 200],
                 [240, 200, 60], [90, 160, 90]]
# io_formats: formats2's and formats3's coders, and their CLI chains
FORMAT_FRAMES = 2      # 10-bit DPX frames of IO_H x IO_W through CLI_CODERS
CT_SLICES, CT_SIZE = 4, 512   # 16-bit DICOM slices through -auto-threshold
FAX_PAGES = 2          # G4 pages through CLI_PAGES
FAX_H, FAX_W = 2156, 1728   # a Letter page at T.4 fine resolution
DPX_CODES = 1          # 10-bit codes the card's DPX chain may move (K1's
                       # 2e-5 against its plain version can cross a
                       # rounding edge)
# io_formats4: formats4's coders, and its CLI chains
DEEP_FRAMES = 2        # 48-bit TIFF frames of IO_H x IO_W through CLI_CODERS
TIFF16_CODES = 2       # 16-bit codes the card's deep chain may move (K1's
                       # 2e-5 against its plain version is 1.3 codes)
GRADE_CODES = 1        # 16-bit codes the card's -hald-clut grade may move
                       # (its float32 trilinear sums, an ulp apart)
CUBE_N = 33            # points a side of the grade's .cube LUT
CALS_PAGES = 2         # CALS pages of FAX_H x FAX_W through CLI_PAGES
HRZ_CODES = 1          # 6-bit codes HRZ's resize on the card may move
YCC_LEVELS = 1         # 8-bit levels YUV's and UYVY's rgb_to_ycbcr on the
                       # card may move (float32 products, an ulp apart)
SMALL4 = (270, 480)    # TXT, FTXT and MAGICK (their text loops), and the
                       # crop on which MAP's and WPG's bytes are the CPU's
MVG4 = ("viewbox 0 0 1920 1080\n"
        "fill 'navy' rectangle 40,40 600,400\n"
        "fill 'gold' circle 900,300 900,420\n"
        "fill 'tomato' ellipse 1400,300 220,120 0,360\n"
        "stroke 'black' stroke-width 6 line 40,600 1880,640\n"
        "fill 'seagreen' polygon 200,700 420,1040 60,1000\n"
        "fill 'none' stroke 'purple' stroke-width 9 "
        "polyline 600,700 800,1000 1000,720 1200,1010\n"
        "fill 'orange' stroke 'none' roundrectangle 1300,600 1800,900 40,40\n"
        "fill 'teal' path 'M 100 450 C 300 350 500 650 700 450 Z'\n"
        "stroke 'crimson' stroke-width 4 fill 'none' "
        "bezier 800,500 1000,420 1200,700 1400,520\n"
        "fill 'skyblue' stroke 'blue' stroke-width 3 "
        "arc 1500,50 1850,250 30,300\n"
        "fill 'black' stroke 'none' point 960,540\n"
        "fill-opacity 0.5 fill 'magenta' rectangle 300,300 1000,800\n"
        "fill-opacity 1 stroke-dasharray 20,10 stroke 'darkred' "
        "stroke-width 5 fill 'none' circle 960,540 960,1000\n"
        "stroke-dasharray none fill 'white' stroke 'black' stroke-width 2 "
        "circle 200,200 200,260 circle 320,200 320,240 "
        "line 1880,40 1500,500 rectangle 1000,40 1200,140 "
        "ellipse 600,980 150,60 0,360 "
        "polygon 1600,700 1700,640 1760,760 1640,800\n"
        "translate 100,0 rotate 10 "
        "fill 'olive' rectangle 1500,950 1700,1050\n")
# io_stream: the out-of-core tier on a scan of 100 megapixels, the last
# coders
SCAN_H, SCAN_W = 8192, 12288   # an 8-bit P6 of 302 MB, 1.2 GB as float32
STREAM_BAND = 512
STREAM_BAND_1080 = 256
STRIP_ROWS = 1024              # the strip of run (ii) held to the CPU's
STRIP_Y0 = 3584
STREAM_STRIP_TOL = 1e-4        # K3's 1e-5 and the resize products' 2e-5,
                               # through level's 1/0.9 stretch and the
                               # unsharp's difference added back
DMR_FRAMES = 4                 # frames of SMALL4 in a DMR resource
CLI_METAFILES = 4              # EMFs and as many WMFs through CLI_CODERS
# cli_tools
TOOLS_FILES = 8        # PNGs of H x W x C through mogrify
TOOLS_TILES = 16       # tiles of the montage
TOOLS_BENCH = 5        # -bench iterations
TOOLS_COMPARE_REL = 1e-5   # a metric printed by compare: float32 sums on
                           # the card in another order than the CPU's
                           # (ncc's 1 - corr: 1e-5 of corr)
TOOLS_SEARCH_REL = 1e-4    # the peak of a float32 FFT correlation
REGION = "800x600+100+100"
PATCH = 64             # the template -subimage-search finds in 540x960
WALK_SMALL = (2, 48, 63)    # frames held bit for bit, an odd width
WALK_N = 4             # 1080p frames through remap(..., dither=True)
WALK_TOP = 8           # rows held to the plain walk of the input's rows
WALK_SIDE = 256        # Riemersma's frame, held to its plain version
STEP_CHAIN = 1 << 16   # dependent steps pw_step_cycles times
WAND_RUNS = 3          # timed runs of the wand phase's chain
MPP_RUNS = 3           # timed runs of the Magick++ and Perl chains
MPP_ALPHA = (540, 960)  # the RGBA frame that the C++ program blurs (K3)
PAR_TOL = 1e-5          # the sharded blur, resize and gigapixel against
                        # K3's plain version and the unsharded resize:
                        # float32 sums in another order
PAR_RUNS = 5            # timed runs of the sharded blur and its unsharded op
K1_DP_TOL = 1e-6        # K1 on a dp block against one call on the batch
GIGA = 32768            # the gigapixel: one GIGA x GIGA x 3 float32 image
GIGA_SIGMA = 2.0        # its blur: 17 taps, halos 8 wide
GIGA_RUNS = 3           # timed runs of process_gigapixel (median)
GIGA_BAND = 64          # rows or columns of each seam and border band
# The C++ chain of the magickpp_perl phase, built against the port's
# Magick++ library once for the card and once for the CPU
# (-DMAGICKPP_DEVICE="cpu").  It counts launches in its own embedded
# interpreter: gpu_kernels.LAUNCHES set to 0 just before a call, read just
# after it.  Arguments: the PPM frame, the RGBA PNG, the PGM page, an
# output folder and the number of timed runs; each result is written
# there as raw float32 RGBA (``*.f32``), the chain also as a 16-bit PPM.
MAGICKPP_CHAIN = r"""
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <Magick++.h>

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

using namespace Magick;
typedef std::chrono::steady_clock Clock;

static std::string py(const char* code, int mode) {
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject* d = PyModule_GetDict(PyImport_AddModule("__main__"));
  PyObject* r = PyRun_String(code, mode, d, d);
  std::string out;
  bool ok = r != 0;
  if (ok) {
    PyObject* s = PyObject_Str(r);
    out = PyUnicode_AsUTF8(s);
    Py_DECREF(s);
    Py_DECREF(r);
  } else {
    PyErr_Print();
  }
  PyGILState_Release(g);
  if (!ok) throw Error(std::string("embedded Python failed: ") + code);
  return out;
}

static void reset() { py("_reset()", Py_eval_input); }
static std::string counts() { return py("_counts()", Py_eval_input); }

static double msSince(Clock::time_point t0) {
  return std::chrono::duration<double, std::milli>(Clock::now() - t0)
      .count();
}

static void dump(const Image& img, const std::string& path) {
  size_t n = img.columns() * img.rows() * 4;
  const float* p = img.getConstPixels(0, 0, img.columns(), img.rows());
  FILE* f = fopen(path.c_str(), "wb");
  if (!f || fwrite(p, sizeof(float), n, f) != n) throw Error("write " + path);
  fclose(f);
}

int main(int argc, char** argv) {
  if (argc != 6) {
    fprintf(stderr, "usage: %s FRAME.ppm RGBA.png PAGE.pgm OUTDIR RUNS\n",
            argv[0]);
    return 2;
  }
  const std::string frame = argv[1], rgba = argv[2], page = argv[3];
  const std::string out = argv[4];
  const int runs = atoi(argv[5]);
  try {
    InitializeMagick(argv[0]);
    py("import torch as _torch\n"
       "from imagemagick_tpu_torch.ops import gpu_kernels as _gk\n"
       "def _sync():\n"
       "    if _torch.cuda.is_available():\n"
       "        _torch.cuda.synchronize()\n"
       "def _reset():\n"
       "    _sync()\n"
       "    for _k in _gk.LAUNCHES:\n"
       "        _gk.LAUNCHES[_k] = 0\n"
       "def _counts():\n"
       "    _sync()\n"
       "    return dict(_gk.LAUNCHES)\n",
       Py_file_input);
    struct Chain {
      std::string frame;
      Image operator()(const std::string& to) const {
        Image img(frame);
        img.resize(Geometry(960, 540));
        img.gaussianBlur(0.0, 2.0);
        img.write(to);
        return img;
      }
    } chain = {frame};
    chain(out + "/warm.ppm");
    reset();
    Image img = chain(out + "/chain16.ppm");
    printf("launches_chain=%s\n", counts().c_str());
    std::vector<double> t;
    for (int i = 0; i < runs; ++i) {
      Clock::time_point t0 = Clock::now();
      chain(out + "/timed.ppm");
      py("_sync()", Py_eval_input);
      t.push_back(msSince(t0));
    }
    std::sort(t.begin(), t.end());
    printf("chain_ms=%.3f\n", t.empty() ? 0.0 : t[t.size() / 2]);
    printf("chain_shape=%zux%zu\n", img.columns(), img.rows());
    dump(img, out + "/chain.f32");

    Image a(rgba);
    reset();
    a.blur(0.0, 2.0);
    printf("launches_alpha=%s\n", counts().c_str());
    dump(a, out + "/alpha.f32");

    Image p(page);
    reset();
    p.autoThreshold(OTSUThresholdMethod);
    printf("launches_otsu=%s\n", counts().c_str());
    dump(p, out + "/otsu.f32");
    return 0;
  } catch (const Exception& e) {
    fprintf(stderr, "MagickException: %s\n", e.what());
    return 1;
  }
}
"""
# The Perl chain of the magickpp_perl phase: the device, the PPM, the
# output file and the number of timed runs; it prints the median ms.
PERL_CHAIN = r"""
use strict;
use warnings;
use Image::Magick;
use Time::HiRes qw(time);
my ($device, $src, $out, $runs) = @ARGV;
$Image::Magick::Device = $device;
sub chain {
    my ($to) = @_;
    my $im = Image::Magick->new;
    for my $x ($im->Read($src), $im->Resize(geometry => '960x540'),
               $im->Blur(radius => 0, sigma => 2), $im->Write($to)) {
        die "$x\n" if $x;
    }
}
chain("$out.warm.ppm");
my @t;
for (1 .. $runs) {
    my $t0 = time;
    chain($out);
    push @t, (time - $t0) * 1000;
}
@t = sort { $a <=> $b } @t;
printf "perl_chain_ms=%.3f\n", $t[int(@t / 2)];
"""
# config #4
N4, H4, W4 = 1, 2160, 4096
NOISE = 0.01
K6_SPEC_TOL = 1e-5  # K6a/K6b vs plain, relative to max|F|: FP32 sums in
                    # another order (radix passes or a p-term generic
                    # pass), FMAs
K6C_TOL = 1e-5      # K6c's [0, 1] output, absolute
# K6a and K6c: config #4's shape, odd factors, a width with a generic
# radix-17 pass and scalar rows (102), the largest extent with an odd row
# count, and a generic radix-4093 pass
K6_ROW_SHAPES = ((N4, H4, W4), (2, 72, 384), (3, 45, 102), (1, 7, 8192),
                 (1, 5, 8186))
# K6b alone: a generic radix-4093 pass down one-column strips, the largest
# extent, an odd H (3.3.3.5) with W not a multiple of the 4-column strip
K6B_SHAPES = ((1, 8186, 64), (1, 8192, 64), (2, 135, 102))
# the H100 SXM's published peaks (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def psnr(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    rms = math.sqrt(float(np.mean((a - b) ** 2)))
    return 20.0 * math.log10(1.0 / max(rms, 1e-12))


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    require(a.shape == b.shape, f"shapes {a.shape} {b.shape}")
    return float((a - b).abs().max().item())


def gauss_taps(n: int, sigma: float) -> np.ndarray:
    j = n // 2
    xs = np.arange(-j, j + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def bound(nbytes: float, flops: float):
    """The least time (ms) the card could take for work that moves
    ``nbytes`` and does ``flops`` float32 operations, and which binds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_flops(Mv: np.ndarray, Mw: np.ndarray, n: int, c: int,
             cout: int) -> int:
    """The multiply-adds of a separable map of n images of c channels to
    cout, two operations each: each axis's operator (Mv (Hout, Hin), Mw
    (Wout, Win)) at its support (its nonzero taps), in the cheaper of the
    two separable orders, with the channel mix folded into the horizontal
    pass.  K1's band and window padding is not counted."""
    nv, nw = np.count_nonzero(Mv), np.count_nonzero(Mw)
    (hout, hin), (wout, win) = Mv.shape, Mw.shape
    w_first = n * hin * nw * c + n * wout * cout * nv
    h_first = n * nv * win * c + n * hout * nw * c
    return 2 * min(w_first, h_first)


def thumbnail_terms(h: int, w: int):
    """Config #5's step operators on the staged layout
    (``imagemagick_tpu/models/thumbnailer.py:110-117``): Lanczos to
    THUMB x THUMB along H, its columns padded to the rows' %8, and along
    W.  Returns ([(Mv, Mw)], rows, lanes) of the layout."""
    from imagemagick_tpu_torch.ops.resize import resize_matrix

    h8 = -(-h // 8) * 8
    wcp = -(-w * 3 // 128) * 128
    Mv = np.pad(resize_matrix(h, THUMB, "lanczos").astype(np.float64).T,
                ((0, 0), (0, h8 - h)))
    Mw = resize_matrix(w, THUMB, "lanczos").astype(np.float64).T
    return [(Mv, Mw)], h8, wcp


def thumbnail_plan(h: int, w: int):
    """K1's plan of config #5's step, as ``fused_linear_pipeline`` makes
    it (identity mix, TO = 64)."""
    from imagemagick_tpu_torch.ops import fused_pipeline as fp

    terms, h8, wcp = thumbnail_terms(h, w)
    return fp.linear_plan(terms, 3, np.eye(3), 64, h8, wcp)


def otsu_bin_f64(img: np.ndarray) -> int:
    """Otsu's bin of one image in numpy: the 256-bin histogram
    (``clip(int(v*255 + 0.5), 0, 255)`` in float32), the between-class
    variance in float64, its first maximum."""
    v = img.astype(np.float32) * np.float32(255) + np.float32(0.5)
    idx = np.clip(v.astype(np.int64), 0, 255)
    p = np.bincount(idx.ravel(), minlength=256).astype(np.float64)
    p /= p.sum()
    omega = np.cumsum(p)
    mu = np.cumsum(p * np.arange(256))
    denom = omega * (1.0 - omega)
    with np.errstate(divide="ignore", invalid="ignore"):
        sigma_b = np.where(denom > 1e-12,
                           (mu[-1] * omega - mu) ** 2 / denom, 0.0)
    return int(np.argmax(sigma_b))


def document_binarize_f64(img: np.ndarray) -> tuple:
    """Config #3 on one (H, W) image in numpy: Otsu's bin, the threshold
    bin * float32(1/255) compared in float32, then open and close by a
    3x3 square and edge 1, each stage padding its own input by
    replicating its border.  Returns (bin, result)."""
    j = otsu_bin_f64(img)
    t = np.float32(j) * np.float32(1.0 / 255)
    y = (img > t).astype(np.float64)

    def window(a, reduce):
        pad = np.pad(a, 1, mode="edge")
        views = [pad[dy:dy + a.shape[0], dx:dx + a.shape[1]]
                 for dy in range(3) for dx in range(3)]
        return reduce(views)

    def mn(a):
        return window(a, lambda vs: np.minimum.reduce(vs))

    def mx(a):
        return window(a, lambda vs: np.maximum.reduce(vs))

    y = mn(mx(mx(mn(y))))
    y = np.clip(9.0 * y - window(y, sum), 0.0, 1.0)
    return j, y


def wiener_f64(x: np.ndarray, noise: float) -> np.ndarray:
    """Config #4 on one (H, W) plane in float64 numpy: fft2, the Wiener
    mask with pmean = sum(x^2), ifft2, the clipped real part."""
    x = x.astype(np.float64)
    f = np.fft.fft2(x)
    p = f.real ** 2 + f.imag ** 2
    g = f * (p / (p + noise * float((x * x).sum())))
    return np.clip(np.fft.ifft2(g).real, 0.0, 1.0)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    require(a.shape == b.shape, f"shapes {a.shape} {b.shape}")
    return float(((a - b).abs().max() / b.abs().max()).item())


def fft_flops(n_elems: int, length: int) -> float:
    """A radix FFT's operation count for the n_elems / length complex
    transforms of that length: 5 * length * log2(length) each."""
    return 5.0 * n_elems * math.log2(length)


def median_ms(*fns, runs: int = RUNS):
    """Median CUDA-event time of each fn, runs interleaved, after a warm-up."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(runs):
        for i, fn in enumerate(fns):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def cuda_events(fn, calls: int) -> list:
    """(name, ms) of every CUDA kernel, memset and copy that ``calls``
    calls of ``fn`` run on the card (after a warm-up call), from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def full_capture(fn, name: str, calls: int, tries: int = 5) -> list:
    """``cuda_events`` of a capture that holds all ``calls`` launches of
    the kernel whose name holds ``name``: the profiler's buffers drop an
    event now and then, which can hide a launch but never add one, so a
    short capture is taken again."""
    for _ in range(tries):
        events = cuda_events(fn, calls)
        if sum(name in n for n, _ in events) == calls:
            return events
    raise RuntimeError(f"chip_smoke: no full profile of {calls} {name} "
                       f"launches in {tries} tries")


def kernels_per_call(fn, name: str, calls: int = 5) -> tuple:
    """The CUDA kernels, memsets and copies one call of ``fn`` runs, as
    (their number a call, their distinct names), from a full capture of
    ``calls`` calls of the kernel named ``name``."""
    events = full_capture(fn, name, calls)
    return len(events) / calls, sorted({n for n, _ in events})


def kernel_ms(fn, name: str, calls: int = DEVICE_LAUNCHES) -> float:
    """The mean duration (ms) of the CUDA kernel whose name holds ``name``
    over ``calls`` calls of ``fn``, on the profiler's clock: the kernel
    alone, without the gaps between launches that host work leaves when
    a kernel is shorter than its wrapper's host time."""
    ms = [t for n, t in full_capture(fn, name, calls) if name in n]
    return sum(ms) / len(ms)


def device_ms(*fns, launches=DEVICE_LAUNCHES):
    """Device-only time (ms) of one call of each fn: after a warm-up, one
    CUDA-event pair around ``launches`` back-to-back calls, over
    ``launches``; median of DEVICE_RUNS such runs, the fns interleaved.
    The stream does not drain between calls, so a call's host work and
    launch latency hide behind the device work queued before it."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(DEVICE_RUNS):
        for i, fn in enumerate(fns):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                fn()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end) / launches)
    return [statistics.median(t) for t in times]


def reset_launches() -> None:
    from imagemagick_tpu_torch.ops import gpu_kernels as gk

    for key in gk.LAUNCHES:
        gk.LAUNCHES[key] = 0


def launched() -> dict:
    from imagemagick_tpu_torch.ops import gpu_kernels as gk

    return dict(gk.LAUNCHES)


def jpeg_codec():
    """(encode, decode, what) of the JPEG codec that config #5 runs here:
    the port's native one where it builds, else PIL's, which
    ``models/thumbnailer.py`` falls back to."""
    from imagemagick_tpu_torch import native

    if native.available():
        return (lambda a: native.encode_jpeg(a, 90), native.decode_jpeg,
                "the port's native codec (native/miniio.cpp)")
    import io

    import PIL
    from PIL import Image as PImage

    def encode(a):
        buf = io.BytesIO()
        PImage.fromarray(a).save(buf, "JPEG", quality=90)
        return buf.getvalue()

    reason = (native.build_error() or "no error text").splitlines()[0]
    return (encode, lambda b: np.asarray(PImage.open(io.BytesIO(b))),
            f"PIL {PIL.__version__}: the native codec did not build here "
            f"({reason})")


def config5_end_to_end(seed: int, dev, gen, name_limit: str,
                       k1_dev_full: float) -> dict:
    """Config #5 through ``thumbnailer.run``: a corpus of CORPUS5 JPEGs of
    512x768 (pixels from ``seed``), one warm run over it twice, then one
    timed run with the launch counts set to 0 just before it."""
    import os
    import tempfile

    from imagemagick_tpu_torch.models import thumbnailer as tn
    from imagemagick_tpu_torch.ops import fused_pipeline as fp

    encode, decode, codec = jpeg_codec()
    print(f"config #5 codec: {codec}")
    rng = np.random.default_rng(seed)
    cfg = tn.ThumbnailerConfig(stage_width=W, stage_height=H, batch_size=N5)
    with tempfile.TemporaryDirectory() as td:
        paths = []
        for i in range(CORPUS5):
            arr = (rng.uniform(0, 1, (H, W, C)) * 255).astype(np.uint8)
            paths.append(os.path.join(td, f"in_{i:04d}.jpg"))
            with open(paths[-1], "wb") as f:
                f.write(encode(arr))
        tn.run(paths * 2, os.path.join(td, "warm"), cfg)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        stats = tn.run(paths, os.path.join(td, "out"), cfg)
        wall = time.perf_counter() - t0
        launches = launched()
        print(f"config #5 run() launches {launches}; stats {stats}")
        require(launches["k1"] == CORPUS5 // N5 and
                sum(launches.values()) == launches["k1"],
                f"config #5 launches {launches}")
        require(stats["images"] == CORPUS5 and stats["size_groups"] == 1,
                f"config #5 stats {stats}")
        require(stats["staged_MB"] == round(
            CORPUS5 * STAGED5[0] * STAGED5[1] / 1e6, 2),
            f"staged {stats['staged_MB']} MB")
        # the step's u8 output on the bytes run() staged, on the card and
        # by the plain step on the CPU
        flats = []
        for p in paths:
            with open(p, "rb") as f:
                flat, (w5, h5) = tn._decode_flat(f.read(), W, H, THUMB,
                                                 THUMB)
            require(flat.shape == STAGED5, f"staged {flat.shape}")
            flats.append(flat)
        staged = torch.from_numpy(np.stack(flats))
        step = tn.make_flat_step(cfg, h5, w5, device=dev)
        plain = tn.make_flat_step(cfg, h5, w5, device="cpu")
        got = torch.cat([step(staged[i:i + N5]).cpu()
                         for i in range(0, CORPUS5, N5)]).numpy()
        want = torch.cat([plain(staged[i:i + N5])
                          for i in range(0, CORPUS5, N5)]).numpy()
        levels = int(np.abs(got.astype(int) - want).max())
        require(got.shape == (CORPUS5, THUMB, THUMB, C) and
                levels <= THUMB_LEVELS, f"config #5 step {levels} levels")
        # every thumbnail decodes to its own image's step output: JPEG at
        # quality 87 keeps little of a noise image's detail, but more of
        # its own than any other image shares with it
        own, other = [], []
        for i, p in enumerate(paths):
            name = os.path.splitext(os.path.basename(p))[0] + ".jpg"
            with open(os.path.join(td, "out", name), "rb") as f:
                thumb = decode(f.read())
            require(thumb.shape == (THUMB, THUMB, C), f"thumb {thumb.shape}")
            own.append(psnr(thumb / 255.0, got[i] / 255.0))
            other.append(psnr(thumb / 255.0, got[(i + 1) % CORPUS5] / 255.0))
        wm_stats, wm_launches, wm_levels, wm_wall = config5_watermark(
            rng, td, paths, cfg, staged, h5, w5, dev)
    print(f"config #5 step vs plain step: {levels} u8 levels at most "
          f"({CORPUS5} images, staged {STAGED5}); thumbnails against their "
          f"own step output {min(own):.2f}-{max(own):.2f} dB, against the "
          f"next image's {min(other):.2f}-{max(other):.2f} dB")
    require(min(own) >= max(other) + 2.0, "a thumbnail is not its image's")

    # K1 at the step's real shape: N5 x 256 rows x 1152 lanes -> 256x256x3
    terms, h8, wcp = thumbnail_terms(h5, w5)
    plan = fp.linear_plan(terms, C, np.eye(C), 64, h8, wcp)
    ops = fp.plan_to_tensors(plan.WV, plan.GB, fp.flat_r0(plan.r0s, N5, h8),
                             dev)
    x = (staged[:N5].to(dev).to(torch.float32) / 255.0).reshape(
        N5 * h8, wcp)

    def kernel():
        return fp.fused_kernel(x, ops, plan.c0s, plan.guids, plan.ntiles)

    def plain_k1():
        return fp._fused_plain(x, ops, plan.c0s, plan.guids, plan.ntiles)

    err = max_err(kernel(), plain_k1())
    torch.cuda.synchronize()
    require(err <= K1_TOL, f"k1 config #5 staged max|d| {err}")
    k1_ms, k1_plain_ms = median_ms(kernel, plain_k1)
    k1_dev, = device_ms(kernel)
    k1_bound = bound(4 * (x.numel() + N5 * THUMB * THUMB * C +
                          ops.WV.numel() + ops.GB.numel()),
                     k1_flops(*terms[0], N5, C, C))
    mp_src = CORPUS5 * H * W / 1e6
    print(f"k1 config #5 staged {(N5, h8, wcp)} -> {(THUMB, THUMB, C)}: "
          f"max|d| {err:.3e}, kernel {k1_ms:.4f} ms ({k1_dev:.4f} "
          f"device-only; {k1_dev_full:.4f} at the full-size 512x768 "
          f"shape), plain {k1_plain_ms:.4f} ms, bound {k1_bound[0]:.4f} ms "
          f"({k1_bound[1]}) [{name_limit}]")
    print(f"config #5 end to end (run(), {CORPUS5} JPEGs of {H}x{W}): "
          f"{wall:.4f} s = {CORPUS5 / wall:.2f} images/s, "
          f"{mp_src / wall:.2f} source MP/s ({stats['megapixels_per_sec']} "
          f"decoded MP/s), overlap_efficiency "
          f"{stats['overlap_efficiency']}, device_drain_wait_s "
          f"{stats['device_drain_wait_s']}, staged_MB {stats['staged_MB']} "
          f"[{name_limit}]")
    print(f"config #5 with a {WATERMARK}x{WATERMARK} RGBA watermark "
          f"(run(watermark_path=...), dissolve 35 % southeast): launches "
          f"{wm_launches}; step vs plain step {wm_levels} u8 levels at most; "
          f"{wm_wall:.4f} s = {CORPUS5 / wm_wall:.2f} images/s against "
          f"{CORPUS5 / wall:.2f} without; overlap_efficiency "
          f"{wm_stats['overlap_efficiency']}, device_drain_wait_s "
          f"{wm_stats['device_drain_wait_s']} [{name_limit}]")
    return {"k1": launches["k1"], "k1_err": err, "k1_wm": wm_launches["k1"]}


def config5_watermark(rng, td: str, paths, cfg, staged, h5: int, w5: int,
                      dev):
    """Config #5 with a watermark: a WATERMARK x WATERMARK RGBA PNG written
    from ``rng``, one warm ``run``, then one timed ``run`` with the launch
    counts set to 0 just before it; the step with the watermark on the
    card against the plain step on the CPU, on the same staged bytes."""
    import os

    from PIL import Image as PImage

    from imagemagick_tpu_torch.models import thumbnailer as tn

    wm = rng.integers(0, 256, (WATERMARK, WATERMARK, 4)).astype(np.uint8)
    wm[..., 3] = np.linspace(64, 255, WATERMARK).astype(np.uint8)[None, :]
    wm_path = os.path.join(td, "watermark.png")
    PImage.fromarray(wm, "RGBA").save(wm_path)
    tn.run(paths, os.path.join(td, "warm_wm"), cfg, watermark_path=wm_path)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    stats = tn.run(paths, os.path.join(td, "out_wm"), cfg,
                   watermark_path=wm_path)
    wall = time.perf_counter() - t0
    launches = launched()
    require(launches["k1"] == CORPUS5 // N5 and
            sum(launches.values()) == launches["k1"],
            f"config #5 watermark launches {launches}")
    require(stats["images"] == CORPUS5, f"config #5 watermark {stats}")
    arr = tn.read_watermark(wm_path)
    step = tn.make_flat_step(cfg, h5, w5, arr, device=dev)
    plain = tn.make_flat_step(cfg, h5, w5, arr, device="cpu")
    got = torch.cat([step(staged[i:i + N5]).cpu()
                     for i in range(0, CORPUS5, N5)]).numpy()
    want = torch.cat([plain(staged[i:i + N5])
                      for i in range(0, CORPUS5, N5)]).numpy()
    levels = int(np.abs(got.astype(int) - want).max())
    require(got.shape == (CORPUS5, THUMB, THUMB, C) and
            levels <= THUMB_LEVELS, f"config #5 watermark {levels} levels")
    for p in paths:
        name = os.path.splitext(os.path.basename(p))[0] + ".jpg"
        require(os.path.getsize(os.path.join(td, "out_wm", name)) > 0,
                f"no watermarked thumbnail {name}")
    return stats, launches, levels, wall


def _cli_run(argv, datas, specs=None):
    """``process(argv)`` over one LazyImage per tensor, then
    ``materialize_all``; synchronizes the card."""
    from imagemagick_tpu_torch import cli
    from imagemagick_tpu_torch.core.image import Image
    from imagemagick_tpu_torch.core.spec import ImageSpec

    st = cli.CLIState()
    for d in datas:
        st.images.append(cli.LazyImage(Image(
            d, specs or ImageSpec(colorspace="srgb"))))
    cli.process(list(argv), st)
    outs = cli.materialize_all(st.images)
    if datas[0].is_cuda:
        torch.cuda.synchronize()
    return outs


def _marginal(run, datas, n1: int, n2: int, rounds: int = 5) -> tuple:
    """Per-image marginal seconds between n1 and n2 images (median of
    ``rounds`` rounds of the best of 3), and the rounds."""
    import timeit

    margs = []
    for _ in range(rounds):
        t1 = min(timeit.repeat(lambda: run(datas[:n1]), number=1, repeat=3))
        t2 = min(timeit.repeat(lambda: run(datas[:n2]), number=1, repeat=3))
        margs.append(max((t2 - t1) / (n2 - n1), 1e-9))
    return statistics.median(margs), margs


def cli_phase(dev, gen, name_limit: str) -> dict:
    """config1_cli: CLI_N2 images of 512x768x3 on the card through
    ``process`` and ``materialize_all`` (one K1 launch), its per-image
    marginal between CLI_N1 and CLI_N2 images, and a chain that dispatch
    declines (K3 on the op route)."""
    from imagemagick_tpu_torch.ops import dispatch
    from imagemagick_tpu_torch.ops import fused_pipeline as fp

    def run(datas):
        return _cli_run(CLI_ARGV, datas)

    datas = list(torch.rand((CLI_N2, H, W, C), generator=gen, device=dev))
    counts = dict(dispatch.COUNTS)
    reset_launches()
    outs = run(datas)
    launches = launched()
    print(f"config1_cli launches {launches}, dispatch counts "
          f"{dispatch.COUNTS} (before {counts})")
    require(launches["k1"] == 1 and launches["k3"] == 0 and
            dispatch.COUNTS["fused"] == counts["fused"] + 1 and
            dispatch.COUNTS["op"] == counts["op"],
            f"config1_cli launches {launches}")
    out = torch.stack([o.data for o in outs])
    require(out.shape == (CLI_N2, HOUT, WOUT, 1) and
            all(o.spec.colorspace == "gray" for o in outs) and
            bool(torch.isfinite(out).all()), f"config1_cli {out.shape}")
    # every image against K1's plain version on CPU copies of the same
    # pixels (float64 costs about a second an image on the host: 4 of them)
    plain = dispatch.try_fused_batch_array(torch.stack(datas).cpu(), TAGS)
    err = max_err(out.cpu(), plain)
    ref = fp.reference_pipeline_f64(torch.stack(datas[:4]).cpu().numpy(),
                                    HOUT, WOUT, "lanczos", SIGMA, GRAY)
    db = psnr(out[:4].cpu().numpy(), ref)
    print(f"config1_cli vs K1's plain version ({CLI_N2} images): max|d| "
          f"{err:.3e}; vs float64 (4 images): {db:.2f} dB")
    require(err <= K1_TOL, f"config1_cli vs plain max|d| {err}")
    require(db >= 100.0, f"config1_cli {db} dB")

    per_img, margs = _marginal(run, datas, CLI_N1, CLI_N2)
    print(f"config1_cli marginal ({CLI_N2}-{CLI_N1} images, median of 5): "
          f"{per_img * 1e3:.4f} ms/image = "
          f"{H * W / 1e6 / per_img:.1f} MP/s; rounds "
          f"{[round(m * 1e3, 4) for m in margs]} ms [{name_limit}]")

    small = torch.rand(CLI_SMALL, generator=gen, device=dev)
    counts = dict(dispatch.COUNTS)
    reset_launches()
    got = torch.stack([o.data for o in run(list(small))])
    small_launches = launched()
    print(f"config1_cli declined chain {CLI_SMALL}: launches "
          f"{small_launches}, dispatch counts {dispatch.COUNTS}")
    require(small_launches["k3"] >= 1 and small_launches["k1"] == 0 and
            dispatch.COUNTS["op"] == counts["op"] + 1 and
            dispatch.COUNTS["fused"] == counts["fused"],
            f"declined chain launches {small_launches}")
    want = torch.stack([o.data for o in run(list(small.cpu()))])
    err = max_err(got.cpu(), want)
    print(f"config1_cli declined chain vs the CPU's: max|d| {err:.3e}")
    require(err <= CLI_OP_TOL, f"declined chain max|d| {err}")
    return {"k1": launches["k1"], "k3": small_launches["k3"]}


def serve_phase(seed: int, name_limit: str) -> dict:
    """config1_serve: a session of SERVE_N u8 images of 512x768x3 on the
    card behind ``make_server`` on loopback, the chain applied with
    keep=1 (one warm-up, SERVE_APPLIES timed, then SERVE_CLIENTS clients
    at once for SERVE_ROUNDS rounds), once more with keep=0, and the
    result fetched."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from http.client import HTTPConnection
    from urllib.parse import quote

    from imagemagick_tpu_torch import serve
    from imagemagick_tpu_torch.ops import dispatch

    srv = serve.make_server(port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]

    def call(method, path, body=None, headers=None) -> bytes:
        conn = HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            out = resp.read()
        finally:
            conn.close()
        require(resp.status == 200, f"{method} {path}: {resp.status} "
                f"{out[:300]!r}")
        return out

    args = quote(" ".join(CLI_ARGV))
    k1 = 0

    def apply(keep: int) -> float:
        nonlocal k1
        reset_launches()
        t0 = time.perf_counter()
        info = json.loads(call("POST",
                               f"/session/s1/apply?keep={keep}&args={args}"))
        wall = time.perf_counter() - t0
        launches = launched()
        require(info["path"] == "fused-batch" and launches["k1"] == 1 and
                sum(launches.values()) == 1,
                f"config1_serve apply {info} launches {launches}")
        k1 += launches["k1"]
        return wall

    try:
        pixels = (np.random.default_rng(seed + 1).random(
            (SERVE_N, H, W, C)) * 255).astype(np.uint8)
        info = json.loads(call("POST", "/session/s1", pixels.tobytes(),
                               {"X-Shape": f"{SERVE_N},{H},{W},{C}",
                                "X-Dtype": "u8"}))
        require(info["platform"] == "cuda", f"session {info}")
        apply(1)                              # tags, plan, operands
        walls = [apply(1) for _ in range(SERVE_APPLIES)]
        # SERVE_CLIENTS clients at once, as benchmarks.py:285-300 runs
        # them: requests overlap their host work with the card's
        with ThreadPoolExecutor(SERVE_CLIENTS) as ex:
            list(ex.map(lambda _: call(
                "POST", f"/session/s1/apply?keep=1&args={args}"),
                range(SERVE_CLIENTS)))
            t0 = time.perf_counter()
            list(ex.map(lambda _: call(
                "POST", f"/session/s1/apply?keep=1&args={args}"),
                range(SERVE_CLIENTS * SERVE_ROUNDS)))
            together = time.perf_counter() - t0
        apply(0)
        got = np.frombuffer(call("GET", "/session/s1"), np.uint8)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    # all SERVE_N images against K1's plain version on the same pixels,
    # run by the CPU through the dispatch plan the server used
    x = torch.from_numpy(pixels).to(torch.float32) / 255.0
    want = serve.clip_u8(dispatch.try_fused_batch_array(x, TAGS)).numpy()
    require(got.size == want.size, f"config1_serve {got.size} bytes")
    levels = int(np.abs(got.reshape(want.shape).astype(int) - want).max())
    require(levels <= 1, f"config1_serve result {levels} levels off")
    per = statistics.median(walls)
    mp = SERVE_N * H * W / 1e6
    print(f"config1_serve: session of {SERVE_N}x{H}x{W}x{C}, result within "
          f"{levels} u8 levels of K1's plain version; request wall (HTTP + "
          f"options + one K1 launch + sync) median of {SERVE_APPLIES} "
          f"{per * 1e3:.4f} ms = {mp / per:.1f} MP/s; walls "
          f"{[round(t * 1e3, 4) for t in walls]} ms [{name_limit}]")
    n_req = SERVE_CLIENTS * SERVE_ROUNDS
    print(f"config1_serve, {SERVE_CLIENTS} clients at once: {n_req} "
          f"requests in {together * 1e3:.4f} ms = "
          f"{together / n_req * 1e3:.4f} ms a request, "
          f"{n_req * mp / together:.1f} MP/s [{name_limit}]")
    return {"k1": k1}


def _scans(gen, dev, n: int) -> torch.Tensor:
    """n letter pages of H3 x W3 scanned in color: tinted paper with
    noise, and lines of dark glyph blocks (pixels from ``gen``)."""
    paper = 0.88 + 0.04 * torch.rand((n, 1, 1, 3), generator=gen, device=dev)
    ink = torch.rand((n, H3 // 12, W3 // 8, 1), generator=gen,
                     device=dev) < 0.3
    ink = ink.repeat_interleave(12, 1).repeat_interleave(8, 2)
    ink &= (torch.arange(H3, device=dev) % 24 < 14)[None, :, None, None]
    page = torch.where(ink, 0.18 + 0.05 * torch.rand(
        (n, 1, 1, 3), generator=gen, device=dev), paper)
    noise = 0.04 * torch.randn((n, H3, W3, 3), generator=gen, device=dev)
    return (page + noise).clamp(0.0, 1.0)


def cli_tone_phase(dev, gen, name_limit: str) -> dict:
    """cli_tone: (a) the thumbnail chain TONE_A on TONE_A_N2 images of
    512x768x3 (one K1 launch); (b) the document chain TONE_B on TONE_B_N2
    color scans of config #3's pages (one K1 and one K4 launch); (c) the
    round trip srgb -> key -> srgb of all 41 colorspaces on ROUNDTRIP_N
    frames of 1080x1920x3; (d) the other options of the slice and the
    distance transform on config #3's page size.  Each on the card
    against the same calls on CPU copies."""
    from imagemagick_tpu_torch.core.geometry import parse_meta_geometry
    from imagemagick_tpu_torch.core.image import Image
    from imagemagick_tpu_torch.core.spec import ImageSpec
    from imagemagick_tpu_torch.ops import colorspace as cs
    from imagemagick_tpu_torch.ops import dispatch
    from imagemagick_tpu_torch.ops import morphology as mo
    from imagemagick_tpu_torch.ops import threshold as th

    # -- (a) the thumbnail chain -----------------------------------------
    datas = list(torch.rand((TONE_A_N2, H, W, C), generator=gen, device=dev))
    counts = dict(dispatch.COUNTS)
    reset_launches()
    outs = _cli_run(TONE_A, datas)
    la = launched()
    print(f"cli_tone (a) {' '.join(TONE_A)}: launches {la}, dispatch "
          f"counts {dispatch.COUNTS} (before {counts})")
    require(la["k1"] == 1 and sum(la.values()) == 1 and
            dispatch.COUNTS["fused"] == counts["fused"] + 1 and
            dispatch.COUNTS["op"] == counts["op"] + TONE_A_N2,
            f"cli_tone (a) launches {la}")
    got = torch.stack([o.data for o in outs])
    want = torch.stack([o.data for o in _cli_run(
        TONE_A, [d.cpu() for d in datas])])
    tw, th_, _, _ = parse_meta_geometry(TONE_A[1], W, H)
    require(got.shape == want.shape == (TONE_A_N2, th_, tw, 3) and
            bool(torch.isfinite(got).all()), f"cli_tone (a) {got.shape}")
    err_a = max_err(got.cpu(), want)
    print(f"cli_tone (a) vs the CPU run (K1's plain version), "
          f"{TONE_A_N2} images: max|d| {err_a:.3e} (tolerance "
          f"{TONE_A_TOL})")
    require(err_a <= TONE_A_TOL, f"cli_tone (a) max|d| {err_a}")
    per_a, rounds = _marginal(lambda d: _cli_run(TONE_A, d), datas,
                              TONE_A_N1, TONE_A_N2)
    print(f"cli_tone (a) marginal ({TONE_A_N2}-{TONE_A_N1} images, median "
          f"of 5): {per_a * 1e3:.4f} ms/image = "
          f"{H * W / 1e6 / per_a:.1f} MP/s; rounds "
          f"{[round(m * 1e3, 4) for m in rounds]} ms [{name_limit}]")
    del datas, outs, got, want

    # -- (b) the document chain ------------------------------------------
    scans = list(_scans(gen, dev, TONE_B_N2))
    counts = dict(dispatch.COUNTS)
    reset_launches()
    outs = _cli_run(TONE_B, scans)
    lb = launched()
    print(f"cli_tone (b) {' '.join(TONE_B)}: launches {lb}, dispatch "
          f"counts {dispatch.COUNTS} (before {counts})")
    require(lb["k1"] == 1 and lb["k4"] == 1 and sum(lb.values()) == 2 and
            dispatch.COUNTS["fused"] == counts["fused"] + 1,
            f"cli_tone (b) launches {lb}")
    got = torch.stack([o.data for o in outs])
    cpu_scans = [d.cpu() for d in scans]
    want = torch.stack([o.data for o in _cli_run(TONE_B, cpu_scans)])
    require(got.shape == want.shape == (TONE_B_N2, H3 // 2, W3 // 2, 1) and
            all(o.spec.colorspace == "gray" for o in outs),
            f"cli_tone (b) {got.shape}")
    # the values before the threshold, and each image's Otsu value, on
    # both devices: the chain's result is those values over that value
    pre = torch.stack([o.data for o in _cli_run(TONE_B[:-2], scans)])
    pre_cpu = torch.stack([o.data for o in _cli_run(TONE_B[:-2],
                                                    cpu_scans)])
    t_card = th.auto_threshold_values(pre)
    t_cpu = th.auto_threshold_values(pre_cpu)
    require(torch.equal(got, (pre > t_card[:, None, None, None]).float()) and
            torch.equal(want, (pre_cpu > t_cpu[:, None, None, None]).float()),
            "cli_tone (b) is not its values over its Otsu value")
    bins_card = torch.round(t_card.cpu() * 255).int().tolist()
    bins_cpu = torch.round(t_cpu * 255).int().tolist()
    require(bins_card == bins_cpu, f"cli_tone (b) Otsu bins {bins_card} "
            f"against the CPU's {bins_cpu}")
    pre_err = max_err(pre.cpu(), pre_cpu)
    differ = got.cpu() != want
    near = (pre_cpu - t_cpu[:, None, None, None]).abs() <= TONE_B_TOL
    n_diff = int(differ.sum())
    print(f"cli_tone (b) Otsu bins {bins_card} equal the CPU's; values "
          f"before the threshold max|d| {pre_err:.3e}; {n_diff} of "
          f"{got.numel()} pixels differ, all within {TONE_B_TOL} of the "
          f"threshold: {bool((near | ~differ).all())}")
    require(pre_err <= TONE_B_TOL and bool((near | ~differ).all()),
            f"cli_tone (b) {n_diff} pixels differ, max|d| {pre_err}")
    per_b, rounds = _marginal(lambda d: _cli_run(TONE_B, d), scans,
                              TONE_B_N1, TONE_B_N2)
    print(f"cli_tone (b) marginal ({TONE_B_N2}-{TONE_B_N1} scans of "
          f"{H3}x{W3}x3, median of 5): {per_b * 1e3:.4f} ms/image = "
          f"{H3 * W3 / 1e6 / per_b:.1f} MP/s; rounds "
          f"{[round(m * 1e3, 4) for m in rounds]} ms [{name_limit}]")
    del scans, cpu_scans, outs, pre, pre_cpu

    # -- (c) every colorspace, srgb -> key -> srgb ------------------------
    frames = torch.rand((ROUNDTRIP_N, H2, W2, C), generator=gen, device=dev)
    image = Image(frames, ImageSpec(colorspace="srgb"))
    image0 = Image(frames[0].cpu(), ImageSpec(colorspace="srgb"))
    image64 = Image(frames[0].cpu().double(), ImageSpec(colorspace="srgb"))
    keys = cs.supported_colorspaces()
    worst = {}
    t0 = time.perf_counter()
    for key in keys:
        back = image.transform_colorspace(key).transform_colorspace("srgb")
        back0 = image0.transform_colorspace(key).transform_colorspace("srgb")
        back64 = image64.transform_colorspace(key).transform_colorspace(
            "srgb")
        require(back.data.shape == (ROUNDTRIP_N, H2, W2, C) and
                back0.data.shape == (H2, W2, C), f"round trip {key}")
        err = max_err(back.data[0].cpu(), back0.data)
        err64 = max_err(back0.data.double(), back64.data)
        tol = max(ROUNDTRIP_TOL, ROUNDTRIP_F64 * err64)
        worst[key] = (err, err64)
        require(err <= tol, f"round trip {key} max|d| {err} > {tol}")
    torch.cuda.synchronize()
    print(f"cli_tone (c) {len(keys)} colorspace round trips on "
          f"{tuple(frames.shape)}, image 0 against the CPU's "
          f"({time.perf_counter() - t0:.1f} s): max|d| (the CPU's float32 "
          f"against float64 in brackets) " +
          ", ".join(f"{k} {v[0]:.2e} ({v[1]:.2e})" for k, v in worst.items()))
    del frames, image

    # -- (d) the other options and the distance transform ----------------
    pages = torch.rand((TONE_D_N, H3, W3, 1), generator=gen, device=dev)
    gray = ImageSpec(colorspace="gray")
    for argv in TONE_D:
        got = torch.stack([o.data for o in _cli_run(argv, list(pages),
                                                    gray)])
        want = torch.stack([o.data for o in _cli_run(
            argv, list(pages.cpu()), gray)])
        require(got.shape == want.shape, f"{argv} {got.shape}")
        if argv[0] == "-random-threshold":
            p = ((pages.double() - 0.2) / 0.6).clamp(0.0, 1.0)
            mean = float(p.sum())
            sd = math.sqrt(float((p * (1 - p)).sum()))
            ok = all(abs(float(v.sum()) - mean) <= 5 * sd + 1
                     for v in (got, want))
            print(f"cli_tone (d) {' '.join(argv)}: white {int(got.sum())} "
                  f"(card), {int(want.sum())} (CPU), expected {mean:.1f} "
                  f"+- {sd:.1f}: within 5 sd {ok}")
            require(ok and bool(((got == 0) | (got == 1)).all()),
                    f"{argv} outside its binomial bound")
            continue
        err = max_err(got.cpu(), want)
        if argv[0] == "-lat":
            from imagemagick_tpu_torch.ops.blur import _depthwise_conv

            box = np.ones((15, 15), np.float32) / 225.0
            gap = (pages.cpu() - _depthwise_conv(pages.cpu(), box) + 0.05)
            differ = got.cpu() != want
            ok = bool(((gap.abs() <= LAT_TOL) | ~differ).all())
            print(f"cli_tone (d) {' '.join(argv)}: {int(differ.sum())} of "
                  f"{got.numel()} pixels differ, all within {LAT_TOL} of "
                  f"the local mean: {ok}")
            require(ok, f"{argv} differs away from its threshold")
            continue
        tol = TONE_D_TOL.get(argv[0], 0.0)
        print(f"cli_tone (d) {' '.join(argv)}: {tuple(got.shape)} max|d| "
              f"{err:.3e} (tolerance {tol})")
        require(err <= tol, f"{argv} max|d| {err}")
    binary = (pages > 0.5).float()
    dist = mo.distance_transform(binary)
    dist_cpu = mo.distance_transform(binary.cpu())
    err = max_err(dist.cpu(), dist_cpu)
    require(err <= 1e-6 and float(dist.max()) > 0.0,
            f"distance transform max|d| {err}")
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        mo.distance_transform(binary)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    dist_ms = statistics.median(times)
    print(f"cli_tone (d) distance_transform (euclidean) of "
          f"{tuple(binary.shape)} binary pages: max|d| {err:.3e} against "
          f"the CPU's; {dist_ms:.4f} ms (median of 5, "
          f"{dist_ms / TONE_D_N:.4f} ms a page) [{name_limit}]")
    return {"k1": la["k1"] + lb["k1"], "k4": lb["k4"]}


def _apart(got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple:
    """(max |got - want|, pixels with a channel further apart than
    ``tol``, pixels) of two (..., C) tensors, ``got`` on the card."""
    require(got.shape == want.shape, f"shapes {got.shape} {want.shape}")
    d = (got.cpu() - want).abs()
    return (float(d.max()), int((d > tol).any(-1).sum()),
            d[..., 0].numel())


def effects_phase(dev, gen, name_limit: str) -> dict:
    """effects: each function of EFFECTS on N2 frames of 1080x1920x3 in
    8-bit levels, with the launch counts set to 0 just before it (one K3
    launch each for EFFECT_K3, none for the rest), its median ms an image
    over EFFECT_RUNS calls, and the card on frame 0 against the CPU on a
    copy of it."""
    from imagemagick_tpu_torch.ops import blur as bl

    frames = torch.round(torch.rand((N2, H2, W2, C), generator=gen,
                                    device=dev) * 255.0) / 255.0
    frame0 = frames[:1].cpu()
    k3 = 0
    for name, args in EFFECTS:
        fn = getattr(bl, name)
        reset_launches()
        out = fn(frames, *args)
        torch.cuda.synchronize()
        la = launched()
        want_k3 = 1 if name in EFFECT_K3 else 0
        require(la["k3"] == want_k3 and sum(la.values()) == want_k3,
                f"effect {name} launches {la}")
        k3 += la["k3"]
        require(out.shape == frames.shape and bool(torch.isfinite(out).all()),
                f"effect {name} {out.shape}")
        del out
        times = []
        for _ in range(EFFECT_RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(frames, *args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times) / N2
        if name == "spread":
            # the card and the CPU draw other streams: both gather at the
            # same offsets, drawn on the CPU
            oy, ox = bl.spread_offsets(frame0, *args,
                                       torch.Generator().manual_seed(0))
            got = bl.spread_at(frames[:1], oy.to(dev), ox.to(dev))
            want = bl.spread_at(frame0, oy, ox)
        else:
            got = fn(frames[:1], *args)
            want = fn(frame0, *args)
        err, n_off, n_px = _apart(got, want, EFFECT_TOL)
        if name == "despeckle":
            require(torch.equal(got.cpu(), want), "despeckle not bit-exact")
        elif name in EFFECT_SELECTS:
            require(n_off <= SELECT_SHARE * n_px,
                    f"effect {name}: {n_off} pixels select otherwise")
        else:
            require(err <= EFFECT_TOL, f"effect {name} max|d| {err}")
        print(f"effects {name}{args} on {tuple(frames.shape)}: launches "
              f"{la}; {ms:.4f} ms an image (median of {EFFECT_RUNS}); frame "
              f"0 vs the CPU: max|d| {err:.3e}, {n_off} of {n_px} pixels "
              f"apart by more than {EFFECT_TOL} [{name_limit}]")
        del got, want
    return {"k3": k3}


def composite_phase(dev, gen, name_limit: str) -> None:
    """composite: every operator of ``ops/composite.py`` on a pair of
    COMPOSITE_N RGBA frames of 1080x1920 on the card, against the same
    call on CPU copies: within COMPOSITE_TOL but for values where a
    comparison inside the operator falls otherwise on the card (at most
    SELECT_SHARE of the values)."""
    from imagemagick_tpu_torch.ops import composite as comp

    dst = torch.rand((COMPOSITE_N, H2, W2, 4), generator=gen, device=dev)
    src = torch.rand((COMPOSITE_N, H2, W2, 4), generator=gen, device=dev)
    dst_cpu, src_cpu = dst.cpu(), src.cpu()
    worst, off = {}, {}
    t0 = time.perf_counter()
    for op in comp.OPERATORS:
        args = COMPOSITE_ARGS.get(op, ())
        got = comp.composite(dst, src, op, True, True, args)
        want = comp.composite(dst_cpu, src_cpu, op, True, True, args)
        require(got.shape == want.shape and
                bool(torch.isfinite(got).all()), f"composite {op}")
        d = (got.cpu() - want).abs()
        far = d > COMPOSITE_TOL
        worst[op] = float(torch.where(far, 0.0, d).max())
        off[op] = int(far.sum())
        require(off[op] <= SELECT_SHARE * d.numel(),
                f"composite {op}: {off[op]} values apart")
    torch.cuda.synchronize()
    print(f"composite: {len(comp.OPERATORS)} operators on 2 x "
          f"{tuple(dst.shape)} RGBA against the CPU "
          f"({time.perf_counter() - t0:.1f} s): max|d| within "
          f"{COMPOSITE_TOL} (values further apart in brackets) " +
          ", ".join(f"{k} {v:.2e} ({off[k]})" for k, v in worst.items()))

    def dissolve():
        return comp.composite(dst, src, "dissolve", True, True, (35.0,))

    ms, = median_ms(dissolve)
    print(f"composite dissolve on {tuple(dst.shape)}: {ms:.4f} ms "
          f"({ms / COMPOSITE_N:.4f} an image) [{name_limit}]")


def cli_effects_phase(dev, gen, name_limit: str) -> dict:
    """cli_effects: CLI_EFFECTS_N2 images of 512x768x3 through
    CLI_EFFECTS (one K1 launch for the group's resize, one K3 launch an
    image for the adaptive blur), then two of them through CLI_COMPOSE;
    each against the same run on CPU copies."""
    from imagemagick_tpu_torch.core.geometry import parse_meta_geometry
    from imagemagick_tpu_torch.core.spec import ImageSpec

    tw, th_, _, _ = parse_meta_geometry(CLI_EFFECTS[1], W, H)
    datas = list(torch.rand((CLI_EFFECTS_N2, H, W, C), generator=gen,
                            device=dev))
    reset_launches()
    outs = _cli_run(CLI_EFFECTS, datas)
    la = launched()
    print(f"cli_effects {' '.join(CLI_EFFECTS)}: launches {la}")
    require(la["k1"] == 1 and la["k3"] == CLI_EFFECTS_N2 and
            sum(la.values()) == 1 + CLI_EFFECTS_N2,
            f"cli_effects launches {la}")
    got = torch.stack([o.data for o in outs])
    cpu_outs = _cli_run(CLI_EFFECTS, [d.cpu() for d in datas])
    want = torch.stack([o.data for o in cpu_outs])
    require(got.shape == (CLI_EFFECTS_N2, th_, tw, C) and
            bool(torch.isfinite(got).all()), f"cli_effects {got.shape}")
    err, n_off, n_px = _apart(got, want, EFFECT_TOL)
    print(f"cli_effects vs the CPU run, {CLI_EFFECTS_N2} images: max|d| "
          f"{err:.3e}, {n_off} of {n_px} pixels apart by more than "
          f"{EFFECT_TOL} (the adaptive level)")
    require(n_off <= SELECT_SHARE * n_px, f"cli_effects {n_off} pixels")
    spec = ImageSpec(colorspace="srgb")
    reset_launches()
    pair = _cli_run(CLI_COMPOSE, [got[0], got[1]], spec)
    lc = launched()
    pair_cpu = _cli_run(CLI_COMPOSE, [want[0], want[1]], spec)
    require(len(pair) == 1 and pair[0].data.shape == (th_, tw, 4) and
            sum(lc.values()) == 0, f"cli_effects composite {lc}")
    err_c, off_c, px_c = _apart(pair[0].data, pair_cpu[0].data, EFFECT_TOL)
    print(f"cli_effects {' '.join(CLI_COMPOSE)}: {tuple(pair[0].data.shape)}"
          f", launches {lc}; vs the CPU run: max|d| {err_c:.3e}, {off_c} of "
          f"{px_c} pixels apart by more than {EFFECT_TOL}")
    require(off_c <= SELECT_SHARE * px_c, f"cli_effects composite {off_c}")
    per, rounds = _marginal(lambda d: _cli_run(CLI_EFFECTS, d), datas,
                            CLI_EFFECTS_N1, CLI_EFFECTS_N2)
    print(f"cli_effects marginal ({CLI_EFFECTS_N2}-{CLI_EFFECTS_N1} images, "
          f"median of 5): {per * 1e3:.4f} ms/image = "
          f"{H * W / 1e6 / per:.1f} MP/s; rounds "
          f"{[round(m * 1e3, 4) for m in rounds]} ms [{name_limit}]")
    return {"k1": la["k1"], "k3": la["k3"]}


def _call_ms(fn, runs: int = DISTORT_RUNS) -> float:
    """Median CUDA-event ms of ``runs`` calls of fn (host work included),
    after a warm-up call."""
    return median_ms(fn, runs=runs)[0]


def transform_phase(dev, gen, name_limit: str) -> None:
    """transform: every function of ``ops/transform.py`` on N2 frames of
    1080x1920x3, required equal to the same call on CPU copies, with its
    ms an image (the output made contiguous: a transpose is a view); trim
    on 4 bordered pages of 1056x816x1."""
    from imagemagick_tpu_torch.ops import transform as tf

    frames = torch.rand((N2, H2, W2, C), generator=gen, device=dev)
    cpu = frames.cpu()
    calls = [("crop", (100, 50, 1280, 720)), ("crop", (-64, -32, 1280, 720)),
             ("crop", (1800, 1000, 256, 256)), ("chop", (200, 100, 64, 32)),
             ("excerpt", (10, 20, 960, 540)), ("extent", (-16, -8, 1952, 1096)),
             ("flip", ()), ("flop", ()), ("roll", (37, -21)),
             ("shave", (8, 8)), ("splice", (100, 50, 16, 8)),
             ("transpose", ()), ("transverse", ()), ("rotate90", ()),
             ("rotate180", ()), ("rotate270", ()), ("auto_orient", (6,)),
             ("auto_orient", (7,)), ("trim", ())]
    parts = []
    for name, args in calls:
        fn = getattr(tf, name)
        got = fn(frames, *args)
        require(torch.equal(got.cpu(), fn(cpu, *args)),
                f"transform {name}{args} differs from the CPU")
        ms = _call_ms(lambda: fn(frames, *args).contiguous())
        parts.append(f"{name}{args} {ms / N2:.4f}")
        del got
    print(f"transform on {tuple(frames.shape)}: every function equal to the "
          f"CPU; ms an image: " + ", ".join(parts) + f" [{name_limit}]")
    pages = torch.ones((4, H3, W3, 1), device=dev)
    pages[:, 40:H3 - 60, 30:W3 - 50] = torch.rand(
        (4, H3 - 100, W3 - 80, 1), generator=gen, device=dev)
    boxes = [tf.trim_bounds(pages[i]) for i in range(4)]
    require(boxes == [tf.trim_bounds(pages[i].cpu()) for i in range(4)] and
            tf.trim_bounds(pages) == boxes[0] == (30, 40, W3 - 80, H3 - 100),
            f"trim boxes {boxes}")
    ms = _call_ms(lambda: [tf.trim(pages[i]) for i in range(4)])
    print(f"transform trim on 4 pages {tuple(pages.shape[1:])}: boxes "
          f"{boxes} equal to the CPU's; {ms / 4:.4f} ms a page [{name_limit}]")


def _distort_methods(h: int, w: int) -> list:
    """(label, method, args, bestfit, per-pixel EWA) at an h x w frame."""
    quad = [0, 0, 0.05 * w, 0.04 * h, w, 0, 0.93 * w, 0.06 * h,
            0, h, 0.02 * w, 0.95 * h, w, h, 0.97 * w, 0.92 * h]
    tri = [0, 0, 0.05 * w, 0.03 * h, w, 0, 0.95 * w, 0.02 * h,
           0, h, 0.03 * w, 0.97 * h]
    return [
        ("srt", "srt", [0.9, 30], False, False),
        ("+srt", "srt", [0.9, 30], True, False),
        ("affine", "affine", tri, False, False),
        ("perspective", "perspective", quad, False, True),
        ("+perspective", "perspective", quad, True, True),
        ("affineprojection", "affineprojection",
         [0.9, 0.1, -0.1, 0.9, 0.05 * w, 0.03 * h], False, False),
        ("perspectiveprojection", "perspectiveprojection",
         [0.95, 0.03, 0.01 * w, 0.02, 0.97, 0.005 * h, 3e-5 * 1920 / w,
          2e-5 * 1080 / h], False, True),
        ("rigidaffine", "rigidaffine", tri, False, False),
        ("bilinearforward", "bilinearforward", quad, False, True),
        ("bilinear", "bilinear", quad, False, True),
        ("polynomial", "polynomial",
         [2] + quad + [0.5 * w, 0.5 * h, 0.52 * w, 0.49 * h,
                       0.25 * w, 0.75 * h, 0.26 * w, 0.77 * h], False, False),
        ("shepards", "shepards", [0.25 * w, 0.25 * h, 0.27 * w, 0.26 * h,
                                  0.75 * w, 0.6 * h, 0.73 * w, 0.62 * h],
         False, True),
        ("resize", "resize", [w // 2, h // 2], False, False),
        ("arc", "arc", [60], False, True),
        ("polar", "polar", [0], False, True),
        ("+polar", "polar", [0], True, True),
        ("depolar", "depolar", [0], False, True),
        ("barrel", "barrel", [0.05, 0.0, 0.0], False, True),
        ("barrelinverse", "barrelinverse", [0.05, 0.0, 0.0], False, True),
        ("cylinder2plane", "cylinder2plane", [60], False, True),
        ("plane2cylinder", "plane2cylinder", [60], False, True),
    ]


def ewa_scan(n: int, chunk: int, nvb: int, kb: int) -> str:
    """The scan that ``ops/distort._ewa_plan``'s (chunk, kb) gives a
    bucket of ``n`` pixels and ``nvb`` scanlines."""
    if chunk < n:
        return "pixel chunks"
    return "scanline blocks" if kb < nvb else "one block"


@contextlib.contextmanager
def ewa_scans(dt, block=None):
    """Yields the set of scans (``ewa_scan``) that the per-pixel EWA calls
    made within take, with ``dt._EWA_BLOCK`` set to ``block`` unless it
    is None."""
    seen = set()
    plan, old = dt._ewa_plan, dt._EWA_BLOCK

    def spy(n, nbc, nvb, uwb):
        chunk, kb = plan(n, nbc, nvb, uwb)
        seen.add(ewa_scan(n, chunk, nvb, kb))
        return chunk, kb

    dt._ewa_plan = spy
    if block is not None:
        dt._EWA_BLOCK = block
    try:
        yield seen
    finally:
        dt._ewa_plan, dt._EWA_BLOCK = plan, old


def _hold(label: str, got: torch.Tensor, want: torch.Tensor) -> str:
    """Require ``got`` (on the card) within DISTORT_TOL of ``want`` but
    for at most SELECT_SHARE of the pixels (where a selection falls
    otherwise); returns the figures."""
    require(bool(torch.isfinite(got).all()), f"distort {label} not finite")
    err, n_off, n_px = _apart(got, want, DISTORT_TOL)
    require(n_off <= SELECT_SHARE * n_px,
            f"distort {label}: {n_off} of {n_px} pixels apart")
    return f"max|d| {err:.3e}, {n_off} of {n_px} px apart by more than " \
        f"{DISTORT_TOL}"


def distort_phase(dev, gen, name_limit: str) -> None:
    """distort: rotate (30 degrees by EWA, also on an RGBA batch, and 90
    exact), every method of ``distort`` (+distort for srt, perspective and
    polar), swirl, implode, wave, the five sparse-color methods, shear and
    deskew on N2 frames of 1080x1920x3, each with its ms an image; frame 0
    against the same call on the CPU (the per-pixel-EWA methods on a frame
    of DISTORT_SMALL, on the card at each of DISTORT_BLOCKS, required to
    cover every scan that the timed call takes); the launches of polar and
    arc; liquid rescale on one LIQUID image, its seams equal to the
    CPU's."""
    from imagemagick_tpu_torch.ops import distort as dt
    from imagemagick_tpu_torch.ops import shear as sh

    frames = torch.rand((N2, H2, W2, C), generator=gen, device=dev)
    f0 = frames[:1].cpu()
    small = torch.rand((1,) + DISTORT_SMALL + (C,), generator=gen,
                       device=dev)
    small_cpu = small.cpu()
    rgba = torch.cat([frames, torch.rand((N2, H2, W2, 1), generator=gen,
                                         device=dev)], -1)
    white = (1.0,) * 4
    t0 = time.perf_counter()

    def run(label, fn, x, x0, per_image=True):
        ms = _call_ms(lambda: fn(x))
        fig = _hold(label, fn(x0.to(dev)), fn(x0))
        n = x.shape[0] if per_image and x.dim() == 4 else 1
        print(f"distort {label} on {tuple(x.shape)}: {ms / n:.4f} ms an "
              f"image; {tuple(x0.shape)} vs the CPU: {fig} [{name_limit}]")

    run("rotate 30", lambda x: dt.rotate(x, 30.0, white[:3]), frames, f0)
    run("rotate 30 RGBA", lambda x: dt.rotate(x, 30.0, white), rgba,
        rgba[:1].cpu())
    got = dt.rotate(frames, 90.0)
    require(torch.equal(got[:1].cpu(), dt.rotate(f0, 90.0)), "rotate 90")
    print(f"distort rotate 90: equal to the CPU; "
          f"{_call_ms(lambda: dt.rotate(frames, 90.0).contiguous()) / N2:.4f}"
          f" ms an image [{name_limit}]")
    del got
    small_args = {m[0]: m[2] for m in _distort_methods(*DISTORT_SMALL)}
    for label, method, args, bestfit, var in _distort_methods(H2, W2):
        with ewa_scans(dt) as timed:
            ms = _call_ms(lambda: dt.distort(frames, method, args,
                                             bestfit=bestfit),
                          DISTORT_EWA_RUNS if var else DISTORT_RUNS)
        x0, a0 = (small_cpu, small_args[label]) if var else (f0, args)
        want = dt.distort(x0, method, a0, bestfit=bestfit)
        compared, figs = set(), []
        for block in DISTORT_BLOCKS if var else (None,):
            with ewa_scans(dt, block) as seen:
                got = dt.distort(x0.to(dev), method, a0, bestfit=bestfit)
            compared |= seen
            figs.append(_hold(f"{label} block {block}", got, want))
        fig = "; ".join(figs)
        require(timed <= compared, f"distort {label}: scans {timed} timed, "
                f"{compared} compared")
        if var:
            fig += (f"; scans timed {sorted(timed)}, compared "
                    f"{sorted(compared)} (blocks {DISTORT_BLOCKS})")
        extra = ""
        if label in ("arc", "polar"):
            n_k = len(cuda_events(lambda: dt.distort(
                frames, method, args, bestfit=bestfit), 1))
            extra = f"; {n_k} CUDA kernels, copies and memsets a call"
        print(f"distort {label}{args[:3]} on {tuple(frames.shape)}: "
              f"{ms / N2:.4f} ms an image{extra}; {tuple(x0.shape)} vs the "
              f"CPU: {fig} [{name_limit}]")
    for label, fn in (("swirl 60", lambda x: dt.swirl(x, 60.0)),
                      ("implode 0.5", lambda x: dt.implode(x, 0.5)),
                      ("wave 25x150", lambda x: dt.wave(x, 25.0, 150.0)),
                      ("shear 20x10", lambda x: sh.shear(x, 20.0, 10.0,
                                                         white[:3]))):
        run(label, fn, frames, f0)
    pts = [(0.1 * W2, 0.1 * H2, (1.0, 0.0, 0.0)),
           (0.9 * W2, 0.2 * H2, (0.0, 1.0, 0.0)),
           (0.3 * W2, 0.8 * H2, (0.0, 0.0, 1.0)),
           (0.7 * W2, 0.6 * H2, (1.0, 1.0, 0.0))]
    for m in ("shepards", "voronoi", "inverse", "barycentric", "bilinear"):
        run(f"sparse-color {m}", lambda x: dt.sparse_color(x, m, pts),
            frames[0], f0[0])
    a_card = sh.deskew_angle_reference(frames[0])
    a_cpu = sh.deskew_angle_reference(f0[0])
    require(a_card == a_cpu, f"deskew angle {a_card} != {a_cpu}")
    run(f"deskew ({a_card:.4f} degrees, equal to the CPU's)",
        lambda x: sh.deskew(x), frames[0], f0[0])
    hl, wl, nl = LIQUID
    img = torch.rand((hl, wl, C), generator=gen, device=dev)
    got = dt.liquid_rescale(img, wl - nl, hl)
    want = dt.liquid_rescale(img.cpu(), wl - nl, hl)
    require(torch.equal(got.cpu(), want), "liquid rescale seams differ")
    ms = _call_ms(lambda: dt.liquid_rescale(img, wl - nl, hl), 1)
    n_k = len(cuda_events(lambda: dt.liquid_rescale(img, wl - 2, hl), 1))
    print(f"distort liquid-rescale {wl}x{hl} -> {wl - nl}x{hl}: seams equal "
          f"to the CPU's; {ms:.4f} ms ({ms / nl:.4f} a seam; {n_k / 2:.0f} "
          f"CUDA kernels, copies and memsets a seam) [{name_limit}]")
    print(f"distort phase: {time.perf_counter() - t0:.1f} s")


def cli_distort_phase(dev, gen, name_limit: str) -> dict:
    """cli_distort: CLI_DISTORT_N2 images of 512x768x3 through CLI_DISTORT
    (one K1 launch for the group's resize, nothing else on a kernel),
    every image against the same run on CPU copies, and the per-image
    marginal between CLI_DISTORT_N1 and CLI_DISTORT_N2 images."""
    datas = list(torch.rand((CLI_DISTORT_N2, H, W, C), generator=gen,
                            device=dev))
    reset_launches()
    outs = _cli_run(CLI_DISTORT, datas)
    la = launched()
    print(f"cli_distort {' '.join(CLI_DISTORT)}: launches {la}")
    require(la["k1"] == 1 and sum(la.values()) == 1,
            f"cli_distort launches {la}")
    got = torch.stack([o.data for o in outs])
    want = torch.stack([o.data for o in
                        _cli_run(CLI_DISTORT, [d.cpu() for d in datas])])
    require(got.shape == want.shape == (CLI_DISTORT_N2, 264, 392, C),
            f"cli_distort {got.shape}")
    print(f"cli_distort vs the CPU run, {CLI_DISTORT_N2} images of "
          f"{tuple(got.shape[1:])}: {_hold('cli_distort', got, want)}")
    per, rounds = _marginal(lambda d: _cli_run(CLI_DISTORT, d), datas,
                            CLI_DISTORT_N1, CLI_DISTORT_N2,
                            CLI_DISTORT_ROUNDS)
    print(f"cli_distort marginal ({CLI_DISTORT_N2}-{CLI_DISTORT_N1} images, "
          f"median of {CLI_DISTORT_ROUNDS}): {per * 1e3:.4f} ms/image = "
          f"{H * W / 1e6 / per:.1f} MP/s; rounds "
          f"{[round(m * 1e3, 4) for m in rounds]} ms [{name_limit}]")
    return {"k1": la["k1"]}


def cli_deskew_phase(dev, gen, name_limit: str) -> None:
    """cli_deskew: DESKEW_N letter pages of 1056x816x1 (text lines on
    paper), each rotated by a seeded angle in [-DESKEW_MAX, DESKEW_MAX]
    degrees with the port's rotate, through CLI_DESKEW; each page's skew
    angle equal to the CPU's, each output against the CPU run."""
    from imagemagick_tpu_torch.core.spec import ImageSpec
    from imagemagick_tpu_torch.ops import distort as dt
    from imagemagick_tpu_torch.ops import shear as sh

    spec = ImageSpec(colorspace="gray")
    angles = ((torch.rand(DESKEW_N, generator=gen, device=dev) * 2 - 1) *
              DESKEW_MAX).tolist()
    ink = torch.rand((DESKEW_N, H3 // 12, W3 // 8, 1), generator=gen,
                     device=dev) < 0.35
    ink = ink.repeat_interleave(12, 1).repeat_interleave(8, 2)
    ink &= (torch.arange(H3, device=dev) % 24 < 14)[None, :, None, None]
    ink[:, :48] = False
    ink[:, -48:] = False
    ink[:, :, :40] = False
    ink[:, :, -40:] = False
    paper = 0.92 + 0.02 * torch.randn((DESKEW_N, H3, W3, 1), generator=gen,
                                      device=dev)
    pages = torch.where(ink, 0.12, paper).clamp(0.0, 1.0)
    pages = [dt.rotate(pages[i], a, (1.0,)) for i, a in enumerate(angles)]
    found = [sh.deskew_angle_reference(p, 0.4) for p in pages]
    found_cpu = [sh.deskew_angle_reference(p.cpu(), 0.4) for p in pages]
    require(found == found_cpu, f"deskew angles {found} != {found_cpu}")
    reset_launches()
    outs = _cli_run(CLI_DESKEW, pages, spec)
    la = launched()
    require(sum(la.values()) == 0, f"cli_deskew launches {la}")
    outs_cpu = _cli_run(CLI_DESKEW, [p.cpu() for p in pages], spec)
    worst = (0.0, 0)
    for i, (g, w_) in enumerate(zip(outs, outs_cpu)):
        require(g.data.shape == w_.data.shape,
                f"cli_deskew page {i}: {g.data.shape} {w_.data.shape}")
        _hold(f"cli_deskew page {i}", g.data, w_.data)
        err, n_off, _ = _apart(g.data, w_.data, DISTORT_TOL)
        worst = (max(worst[0], err), max(worst[1], n_off))
    ms = _call_ms(lambda: _cli_run(CLI_DESKEW, pages, spec), 1)
    print(f"cli_deskew {' '.join(CLI_DESKEW)} on {DESKEW_N} pages of "
          f"{H3}x{W3}x1 rotated by "
          f"{[round(a, 3) for a in angles]} degrees: found "
          f"{[round(a, 3) for a in found]}, equal to the CPU's; outputs "
          f"{[tuple(o.data.shape) for o in outs[:3]]}...; vs the CPU: "
          f"max|d| {worst[0]:.3e}, at most {worst[1]} px of a page apart by "
          f"more than {DISTORT_TOL}; {ms / DESKEW_N:.4f} ms a page "
          f"[{name_limit}]")


def _timed(label: str, fn):
    """Run fn, print its seconds on the host clock, return its result."""
    t0 = time.perf_counter()
    out = fn()
    print(f"{label} phase: {time.perf_counter() - t0:.1f} s")
    return out


def fx_phase(dev, gen, name_limit: str) -> None:
    """fx: each expression of FX_EXPRS over N2 frames of 1080x1920x3 (u)
    and a second batch (v) on the card, with no kernel of the port's:
    ms an image, CUDA kernels a call, and frame 0 against the same call
    on CPU copies (at most SELECT_SHARE of the pixels further apart than
    FX_TOL); rand by its moments and equal channels."""
    from imagemagick_tpu_torch.ops import fx

    u = torch.rand((N2, H2, W2, C), generator=gen, device=dev)
    v = torch.rand((N2, H2, W2, C), generator=gen, device=dev)
    u0, v0 = u[:1].cpu(), v[:1].cpu()
    for label, expr in FX_EXPRS:
        reset_launches()
        out = fx.fx([u, v], expr)
        torch.cuda.synchronize()
        la = launched()
        require(sum(la.values()) == 0, f"fx {expr} launches {la}")
        require(out.shape == u.shape and bool(torch.isfinite(out).all()),
                f"fx {expr} {out.shape}")
        ms = _call_ms(lambda: fx.fx([u, v], expr)) / N2
        nk = len(cuda_events(lambda: fx.fx([u, v], expr), 1))
        if expr == "rand()":
            mean, var = float(out.mean()), float(out.var())
            n = out[..., 0].numel()
            require(abs(mean - 0.5) < 5 * (1 / 12 / n) ** 0.5 and
                    abs(var - 1 / 12) < 5 * (1 / 180 / n) ** 0.5 and
                    torch.equal(out[..., 0], out[..., 2]),
                    f"fx rand moments {mean} {var}")
            held = f"mean {mean:.6f}, variance {var:.6f} (1/12 = " \
                f"{1 / 12:.6f}), channels equal"
        else:
            err, n_off, n_px = _apart(out[:1], fx.fx([u0, v0], expr), FX_TOL)
            require(n_off <= SELECT_SHARE * n_px,
                    f"fx {expr}: {n_off} of {n_px} pixels apart")
            held = f"frame 0 vs the CPU: max|d| {err:.3e}, {n_off} of " \
                f"{n_px} px apart by more than {FX_TOL}"
        print(f"fx {label} {expr!r} on 2 x {tuple(u.shape)}: {ms:.4f} ms an "
              f"image, {nk} CUDA kernels a call; {held} [{name_limit}]")
        del out


def _ssim_f64(a: np.ndarray, b: np.ndarray) -> float:
    """SSIM's formula in float64 numpy: the sampled 11x11 gaussian
    (sigma 1.5) applied as two 11-tap passes with edge padding."""
    u = np.arange(-5, 6, dtype=np.float64)
    k = np.exp(-(u * u) / (2.0 * 1.5 * 1.5))
    k /= k.sum()

    def win(x):
        p = np.pad(x, [(0, 0), (5, 5), (5, 5), (0, 0)], mode="edge")
        h, w = x.shape[1], x.shape[2]
        r = sum(k[i] * p[:, i:i + h] for i in range(11))
        return sum(k[i] * r[:, :, i:i + w] for i in range(11))

    mu_a, mu_b = win(a), win(b)
    var_a = win(a * a) - mu_a * mu_a
    var_b = win(b * b) - mu_b * mu_b
    cov = win(a * b) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    num = (2.0 * mu_a * mu_b + c1) * (2.0 * cov + c2)
    den = (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)
    return float(np.mean(num / np.maximum(den, 1e-30)))


def _metrics_f64(a: np.ndarray, b: np.ndarray) -> dict:
    """Each metric of compare.py's _METRICS but phash and ssim, its
    formula evaluated in float64 numpy."""
    d = a - b
    axes = tuple(range(a.ndim - 1))
    mse_c = np.mean(d * d, axis=axes)
    am = a - a.mean(axis=axes)
    bm = b - b.mean(axis=axes)
    ncc = float(np.mean(np.sum(am * bm, axis=axes) / np.sqrt(
        np.sum(am * am, axis=axes) * np.sum(bm * bm, axis=axes))))
    fa = np.fft.rfft2(a.mean(-1))
    fb = np.fft.rfft2(b.mean(-1))
    cross = fa * np.conj(fb)
    cross /= np.maximum(np.abs(cross), 1e-30)
    mse = float(np.mean(d * d))
    return {
        "ae": float(np.any(d != 0, axis=-1).sum()),
        "mae": float(np.mean(np.abs(d))), "mse": mse,
        "rmse": math.sqrt(mse), "pae": float(np.abs(d).max()),
        "psnr": float(np.mean(np.where(mse_c >= 1e-12, -10.0 * np.log10(
            np.maximum(mse_c, 1e-12)) / 48.1647, 0.0))),
        "ncc": ncc, "dpc": ncc, "fuzz": math.sqrt(mse),
        "phase": float(np.fft.irfft2(cross, s=a.shape[-3:-1]).max()),
        "mepp": float(np.abs(d).sum() * 65535.0)}


def compare_phase(dev, gen, name_limit: str) -> None:
    """compare: every metric of _METRICS on a pair of N2 frames of
    1080x1920x3 on the card (phash on frame 0: its pipeline takes one
    image; one call on the host clock), ms a call, against its formula in
    float64 numpy within COMPARE_REL relative (ae as a count; ssim and
    dssim on SSIM_FRAMES pairs, dssim through 1 - 2 dssim); compare_images against the CPU
    (equal) and similarity_image finding a 128x128 crop at its offset."""
    from imagemagick_tpu_torch.ops import compare as cm
    from imagemagick_tpu_torch.ops import statistic as stx

    a = torch.rand((N2, H2, W2, C), generator=gen, device=dev)
    b = torch.clamp(a + 0.1 * (torch.rand(a.shape, generator=gen,
                                          device=dev) - 0.5), 0.0, 1.0)
    a64 = a.cpu().numpy().astype(np.float64)
    b64 = b.cpu().numpy().astype(np.float64)
    t0 = time.perf_counter()
    refs = _metrics_f64(a64, b64)
    ns = SSIM_FRAMES
    refs["ssim"] = _ssim_f64(a64[:ns], b64[:ns])
    refs["dssim"] = (1.0 - refs["ssim"]) / 2.0
    ha = stx._phash_host(a64[0, ..., :3])
    hb = stx._phash_host(b64[0, ..., :3])
    refs["phash"] = float(np.sum((ha - hb) ** 2))
    print(f"compare float64 references: {time.perf_counter() - t0:.1f} s")
    parts = []
    for m in sorted(cm._METRICS):
        aa, bb = (a[0], b[0]) if m == "phash" else \
            (a[:ns], b[:ns]) if m in ("ssim", "dssim") else (a, b)
        reset_launches()
        t0 = time.perf_counter()
        got = float(cm.get_distortion(aa, bb, m))
        once_ms = (time.perf_counter() - t0) * 1e3
        la = launched()
        require(sum(la.values()) == 0, f"compare {m} launches {la}")
        want = refs[m]
        if m == "ae":
            require(got == want, f"compare ae {got} != {want}")
            rel = 0.0
        elif m == "dssim":
            rel = abs((1 - 2 * got) - (1 - 2 * want)) / abs(1 - 2 * want)
        else:
            rel = abs(got - want) / max(abs(want), 1e-30)
        require(rel <= COMPARE_REL, f"compare {m}: {got} vs {want}")
        if m == "phash":     # seconds on the host: the call above, timed
            ms = once_ms
        else:
            ms = _call_ms(lambda: cm.get_distortion(aa, bb, m))
        parts.append(f"{m} {got:.7g} (float64 {want:.7g}, rel {rel:.1e}, "
                     f"{ms:.4f} ms)")
    print(f"compare metrics on 2 x {tuple(a.shape)} (phash frame 0, ssim "
          f"and dssim {ns} pairs): " + "; ".join(parts) + f" [{name_limit}]")
    vis, _ = cm.compare_images(a, b, "rmse")
    want_vis, _ = cm.compare_images(a[:1].cpu(), b[:1].cpu(), "rmse")
    require(torch.equal(vis[:1].cpu(), want_vis), "compare_images")
    ms_ci = _call_ms(lambda: cm.compare_images(a, b, "rmse"))
    y0, x0 = [int(float(t) * (n - 128)) for t, n in zip(
        torch.rand(2, generator=gen, device=dev), (H2, W2))]
    tpl = a[0, y0:y0 + 128, x0:x0 + 128]
    (y, x), _ = cm.similarity_image(a[0], tpl)
    (yc, xc), _ = cm.similarity_image(a[0].cpu(), tpl.cpu())
    require((y, x) == (yc, xc) == (y0, x0),
            f"similarity {(y, x)} {(yc, xc)} {(y0, x0)}")
    ms_si = _call_ms(lambda: cm.similarity_image(a[0], tpl))
    print(f"compare_images on {tuple(a.shape)}: {ms_ci:.4f} ms, frame 0 "
          f"equal to the CPU; similarity_image of a 128x128 crop in frame 0: "
          f"found at {(y, x)} as on the CPU, {ms_si:.4f} ms [{name_limit}]")


def quantize_phase(dev, gen, name_limit: str) -> None:
    """quantize: the octree to 256 colors with each dither and posterize
    4 with each dither on QUANT_N frames of 1080x1920x3 (the native
    library on the host, on the host clock; frame 0 equal to the CPU call
    bit for bit); kmeans_quantize 16 on N2 frames (labels apart against the CPU
    on frame 0); kmeans_reference 8 on one frame (the device path;
    pixels apart and the iterations of each); unique_colors_count
    (exact); image_type, image_depth and each set_image_type target."""
    from imagemagick_tpu_torch import native
    from imagemagick_tpu_torch.ops import attribute as at
    from imagemagick_tpu_torch.ops import quantize as qz

    frames = torch.rand((N2, H2, W2, C), generator=gen, device=dev)
    host = frames[:QUANT_N].cpu()
    arrs = host.numpy()
    for dither in ("none", "riemersma", "fs"):
        t0 = time.perf_counter()
        outs = [native.octree_quantize(arrs[i], 256, dither)
                for i in range(QUANT_N)]
        sec = (time.perf_counter() - t0) / QUANT_N
        again = native.octree_quantize(arrs[0].copy(), 256, dither)
        require(np.array_equal(outs[0][0], again[0]) and
                np.array_equal(outs[0][1], again[1]), f"octree {dither}")
        print(f"quantize octree 256 colors, dither {dither}, on {QUANT_N} x "
              f"{(H2, W2, C)}: {sec:.3f} s a frame on the host, "
              f"{len(outs[0][1])} colors in frame 0, equal to a second call")
    for dither in (False, True, "fs"):
        reset_launches()
        t0 = time.perf_counter()
        got = qz.posterize(frames[:QUANT_N], 4, dither)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / QUANT_N
        require(sum(launched().values()) == 0 and got.device == frames.device,
                f"posterize {dither}")
        require(torch.equal(got[:1].cpu(), qz.posterize(host[:1], 4, dither)),
                f"posterize {dither} differs from the CPU")
        print(f"quantize posterize 4, dither {dither}, on {QUANT_N} x "
              f"{(H2, W2, C)}: {sec * 1e3:.3f} ms a frame (host clock, the "
              f"copies included), frame 0 equal to the CPU [{name_limit}]")
    reset_launches()
    ms = _call_ms(lambda: qz.kmeans_quantize(frames, 16), 1)
    require(sum(launched().values()) == 0, "kmeans launches")
    pal, lab = qz.kmeans(frames[:1], 16)
    cpal, clab = qz.kmeans(frames[:1].cpu(), 16)
    apart = int((lab.cpu() != clab).sum())
    require(apart <= SELECT_SHARE * clab.numel(), f"kmeans {apart} labels")
    print(f"quantize kmeans_quantize 16 on {tuple(frames.shape)}: {ms:.4f} "
          f"ms ({ms / N2:.4f} an image); kmeans 16 on frame 0 against the "
          f"CPU: {apart} of {clab.numel()} labels apart, palettes max|d| "
          f"{float((pal.cpu() - cpal).abs().max()):.3e} [{name_limit}]")
    st_card, st_cpu = {}, {}
    t0 = time.perf_counter()
    got = qz.kmeans_reference(frames[0], 8, stats=st_card)
    torch.cuda.synchronize()
    sec_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = qz.kmeans_reference(frames[0].cpu(), 8, stats=st_cpu)
    sec_cpu = time.perf_counter() - t0
    err, n_off, n_px = _apart(got, want, 1e-5)
    route = "device" if H2 * W2 > (1 << 20) else "host"
    require(st_card["route"] == route and
            n_off <= SELECT_SHARE * n_px, f"kmeans_reference {n_off}")
    print(f"quantize kmeans_reference 8 on {(H2, W2, C)} ({route} path): "
          f"{sec_card:.3f} s, {st_card['iterations']} iterations; the CPU "
          f"{sec_cpu:.3f} s, {st_cpu['iterations']} iterations; {n_off} of "
          f"{n_px} pixels apart by more than 1e-5 (max|d| {err:.3e}) "
          f"[{name_limit}]")
    post = torch.round(frames * 7) / 7
    for label, img in (("random", frames), ("posterized", post)):
        t0 = time.perf_counter()
        n = int(qz.unique_colors_count(img))
        sec = time.perf_counter() - t0
        require(n == int(qz.unique_colors_count(img.cpu())),
                f"unique colors {label}")
        print(f"quantize unique_colors_count of {label} "
              f"{tuple(img.shape)}: {n}, equal to the CPU's; {sec:.3f} s")
    f0, p0 = frames[0], post[0]
    types = [at.image_type(f0), at.image_type(p0)]
    depths = [at.image_depth(f0), at.image_depth(p0)]
    require(types == [at.image_type(f0.cpu()), at.image_type(p0.cpu())] and
            depths == [at.image_depth(f0.cpu()), at.image_depth(p0.cpu())],
            f"image_type {types} depth {depths}")
    parts = []
    for t in ("bilevel", "grayscale", "palette", "truecolor"):
        t0 = time.perf_counter()
        got = at.set_image_type(f0, t)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        err, n_off, n_px = _apart(got, at.set_image_type(f0.cpu(), t), 1e-5)
        require(got.device == f0.device and n_off <= SELECT_SHARE * n_px,
                f"set_image_type {t}: {n_off}")
        parts.append(f"{t} {tuple(got.shape)} {sec:.3f} s, {n_off} px apart")
    print(f"attribute on {(H2, W2, C)}: types {types}, depths {depths} as on "
          f"the CPU; set_image_type " + "; ".join(parts) + f" [{name_limit}]")


def _cli_quiet(argv, datas):
    """``_cli_run`` with -compare's distortion caught; (outs, stderr)."""
    import io

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        outs = _cli_run(argv, datas)
    return outs, err.getvalue()


def _hold_from_resize(label: str, argv, datas, outs) -> str:
    """Hold a chain whose head is ``-resize 256x256`` (K1 on the card, its
    plain version on the CPU): the resize within K1_TOL of the CPU's, and
    the rest of the chain run on the CPU from the card's resized images
    equal to the card's outputs (the octree and dither walks choose
    otherwise on inputs an ulp apart, so the whole chain on the CPU is
    only counted)."""
    head, rest = argv[:2], argv[2:]
    resized = [o.data for o in _cli_run(head, datas)]
    err = max_err(torch.stack(resized).cpu(), torch.stack(
        [o.data for o in _cli_run(head, [d.cpu() for d in datas])]))
    require(err <= K1_TOL, f"{label} resize max|d| {err}")
    replay, _ = _cli_quiet(rest, [r.cpu() for r in resized])
    require(len(replay) == len(outs), f"{label} {len(replay)} outputs")
    eq = all(torch.equal(o.data.cpu(), r.data) for o, r in zip(outs, replay))
    worst = max(_apart(o.data, r.data, 1e-5)[1] for o, r in zip(outs, replay))
    require(worst <= SELECT_SHARE * outs[0].data[..., 0].numel(),
            f"{label}: {worst} px apart from the replay")
    full, _ = _cli_quiet(argv, [d.cpu() for d in datas])
    apart = sum(_apart(o.data, f.data, 1e-5)[1] for o, f in zip(outs, full))
    n_px = sum(o.data[..., 0].numel() for o in outs)
    return f"resize vs the CPU max|d| {err:.3e}; the rest replayed on the " \
        f"CPU from the card's resize: {'equal' if eq else f'{worst} px'}; " \
        f"the whole chain on the CPU: {apart} of {n_px} px apart by more " \
        f"than 1e-5"


def cli_channel_phase(dev, gen, name_limit: str) -> dict:
    """cli_channel: CLI_CHANNEL_N2 images of 512x768x3 through chain A
    (each image on its own: one K1 launch for the group's resize), the
    per-image marginal between CLI_CHANNEL_N1 and CLI_CHANNEL_N2 images;
    then chain B's list ops, one run each (one K1 launch each)."""
    from imagemagick_tpu_torch.core.geometry import parse_meta_geometry

    tw, th_, _, _ = parse_meta_geometry(CLI_CHANNEL_A[1], W, H)
    datas = list(torch.rand((CLI_CHANNEL_N2, H, W, C), generator=gen,
                            device=dev))
    reset_launches()
    outs = _cli_run(CLI_CHANNEL_A, datas)
    la = launched()
    require(la["k1"] == 1 and sum(la.values()) == 1,
            f"cli_channel A launches {la}")
    require(all(tuple(o.data.shape) == (th_, tw, 1) and
                o.spec.colorspace == "gray" for o in outs),
            f"cli_channel A {outs[0].data.shape}")
    k1 = la["k1"]
    print(f"cli_channel A {' '.join(CLI_CHANNEL_A)} on {CLI_CHANNEL_N2} "
          f"images: launches {la}; "
          f"{_hold_from_resize('cli_channel A', CLI_CHANNEL_A, datas, outs)}")
    per, rounds = _marginal(lambda d: _cli_run(CLI_CHANNEL_A, d), datas,
                            CLI_CHANNEL_N1, CLI_CHANNEL_N2,
                            CLI_CHANNEL_ROUNDS)
    print(f"cli_channel A marginal ({CLI_CHANNEL_N2}-{CLI_CHANNEL_N1} "
          f"images, median of {CLI_CHANNEL_ROUNDS}): {per * 1e3:.4f} "
          f"ms/image = "
          f"{H * W / 1e6 / per:.1f} MP/s; rounds "
          f"{[round(m * 1e3, 4) for m in rounds]} ms [{name_limit}]")
    for argv, n in CLI_CHANNEL_B:
        reset_launches()
        outs, err_text = _cli_quiet(argv, datas[:n])
        la = launched()
        require(la["k1"] == 1 and sum(la.values()) == 1 and len(outs) == 1
                and tuple(outs[0].data.shape) == (th_, tw, C),
                f"cli_channel {argv} launches {la}")
        k1 += la["k1"]
        if "-colors" in argv:
            held = _hold_from_resize("cli_channel B", argv, datas[:n], outs)
        else:
            want, want_err = _cli_quiet(argv, [d.cpu() for d in datas[:n]])
            e, n_off, n_px = _apart(outs[0].data, want[0].data, K1_TOL)
            require(n_off <= SELECT_SHARE * n_px, f"{argv}: {n_off} px")
            held = f"vs the CPU run: max|d| {e:.3e}, {n_off} of {n_px} px " \
                f"apart by more than {K1_TOL}"
            if err_text:
                d = abs(float(err_text) - float(want_err))
                require(d <= K1_TOL, f"{argv} distortion {err_text}")
                held += f"; distortion {float(err_text):.7g} (the CPU's " \
                    f"{float(want_err):.7g})"
        ms = _call_ms(lambda: _cli_quiet(argv, datas[:n]))
        print(f"cli_channel B {' '.join(argv)} on {n} image(s): launches "
              f"{la}, {ms:.4f} ms a call; {held} [{name_limit}]")
    return {"k1": k1}


def _scenes(gen, dev, n: int) -> torch.Tensor:
    """n frames of H2 x W2 x 3 in 8-bit levels: a mosaic of flat 60-pixel
    blocks (straight edges for Canny and Hough), a smooth shading and mild
    noise (pixels from ``gen``)."""
    blocks = torch.rand((n, H2 // 60 + 1, W2 // 60 + 1, 3), generator=gen,
                        device=dev)
    mosaic = blocks.repeat_interleave(60, 1).repeat_interleave(60, 2)
    yy = torch.arange(H2, device=dev)[:, None] / H2
    xx = torch.arange(W2, device=dev)[None, :] / W2
    shade = 0.15 * torch.sin(6.0 * yy + 3.0 * xx)[None, ..., None]
    noise = 0.01 * torch.randn((n, H2, W2, 3), generator=gen, device=dev)
    x = 0.7 * mosaic[:, :H2, :W2] + shade + noise + 0.15
    return torch.round(x.clamp(0.0, 1.0) * 255.0) / 255.0


def _pages(gen, dev, n: int) -> torch.Tensor:
    """n binary letter pages of H3 x W3 x 1: ``_scans``' glyph blocks
    thresholded at half intensity, SPECKS of the pixels flipped."""
    page = (_scans(gen, dev, n).mean(-1, keepdim=True) > 0.5).float()
    flip = torch.rand(page.shape, generator=gen, device=dev) < SPECKS
    return torch.where(flip, 1.0 - page, page)


def _once_ms(fn) -> float:
    """CUDA-event ms of one call of fn (host work included)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _equal_count(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of ``got`` (on the card) that differ from ``want``."""
    require(got.shape == want.shape, f"shapes {got.shape} {want.shape}")
    return int((got.cpu() != want).sum())


def vision_phase(dev, gen, name_limit: str) -> dict:
    """vision: on N2 frames of 1080x1920x3 Canny (its blur one K3 launch;
    the rest replayed on the CPU from the card's blur, equal; the whole
    CPU run's pixels apart counted), mean shift (equal to the CPU on a
    MS_CROP crop of frame 0), segment (frame 0 equal to the CPU's) and
    the GLCM (counts and metrics equal); on N3 binary letter pages CCL at
    4 and 8 neighbours (pages [:CCL_CPU_PAGES] equal to the CPU's), the
    merge of objects under AREA_MIN pixels (host, each page), the area
    threshold and HoughLineImage (page 0 equal).  ms an image each."""
    from imagemagick_tpu_torch.ops import blur as bl
    from imagemagick_tpu_torch.ops import enhance as en
    from imagemagick_tpu_torch.ops import feature as ft
    from imagemagick_tpu_torch.ops import segment as sg
    from imagemagick_tpu_torch.ops import vision as vi

    frames = _scenes(gen, dev, N2)
    cpu0 = frames[:1].cpu()
    canny = (0.0, 1.0, 0.1, 0.3)
    reset_launches()
    edges = ft.canny_edge(frames, *canny)
    torch.cuda.synchronize()
    la = launched()
    require(la["k3"] == 1 and sum(la.values()) == 1,
            f"vision canny launches {la}")
    k3 = la["k3"]
    ms = _call_ms(lambda: ft.canny_edge(frames, *canny)) / N2
    smooth = bl.blur(en.grayscale(frames), 0.0, 1.0)[..., 0].cpu()
    replay = ft.canny_from_smooth(smooth, 0.1, 0.3)
    n_replay = _equal_count(edges[..., 0] > 0, replay)
    require(n_replay == 0, f"vision canny: {n_replay} px apart from the "
            f"replay from the card's blur")
    n_full = _equal_count(edges, ft.canny_edge(frames.cpu(), *canny))
    print(f"vision canny_edge{canny} on {tuple(frames.shape)}: launches {la}, "
          f"{ms:.4f} ms an image, {int(edges.sum())} edge px; the rest "
          f"replayed on the CPU from the card's blur: {n_replay} px apart; "
          f"the whole CPU run: {n_full} of {edges.numel()} px apart "
          f"[{name_limit}]")
    del edges, smooth, replay

    reset_launches()
    ms = _once_ms(lambda: ft.mean_shift(frames, 7, 7, 0.1)) / N2
    require(sum(launched().values()) == 0, f"mean shift {launched()}")
    crop = frames[:1, :MS_CROP[0], :MS_CROP[1]]
    n_ms = _equal_count(ft.mean_shift(crop, 7, 7, 0.1),
                        ft.mean_shift(crop.cpu(), 7, 7, 0.1))
    require(n_ms == 0, f"mean shift: {n_ms} values apart")
    print(f"vision mean_shift(7x7, 0.1) on {tuple(frames.shape)}: {ms:.4f} "
          f"ms an image (one call); a {MS_CROP[0]}x{MS_CROP[1]} crop of "
          f"frame 0 vs the CPU: {n_ms} of {crop.numel()} values apart "
          f"[{name_limit}]")

    reset_launches()
    out = sg.segment(frames)
    torch.cuda.synchronize()
    require(sum(launched().values()) == 0 and out.shape == frames.shape,
            f"segment {launched()} {out.shape}")
    ms = _once_ms(lambda: sg.segment(frames)) / N2
    n_colors = int(torch.unique(out.reshape(-1, C), dim=0).shape[0])
    n_seg = _equal_count(sg.segment(frames[:1]), sg.segment(cpu0))
    require(n_seg == 0, f"segment: {n_seg} values apart")
    print(f"vision segment on {tuple(frames.shape)}: {ms:.4f} ms an image "
          f"(one call), {n_colors} cluster colors; frame 0 alone vs the "
          f"CPU: {n_seg} of {cpu0.numel()} values apart [{name_limit}]")
    del out

    counts = ft.glcm_counts(frames)
    require(torch.equal(counts.cpu(), ft.glcm_counts(frames.cpu())),
            "glcm counts")
    got, want = ft.glcm_features(frames), ft.glcm_features(frames.cpu())
    require(all(float(got[k]) == float(want[k]) for k in want),
            "glcm features")
    ms = _call_ms(lambda: ft.glcm_features(frames)) / N2
    print(f"vision glcm_features on {tuple(frames.shape)}: {ms:.4f} ms an "
          f"image; counts (sum {int(counts.sum())}) and the six metrics "
          f"equal to the CPU's; contrast {float(got['contrast']):.6f} "
          f"[{name_limit}]")
    del frames, cpu0

    pages = _pages(gen, dev, N3)
    want_pages = pages[:CCL_CPU_PAGES].cpu()
    for conn in (4, 8):
        reset_launches()
        labels = vi.connected_components(pages, conn)
        torch.cuda.synchronize()
        require(sum(launched().values()) == 0, f"ccl {launched()}")
        ms = _once_ms(lambda: vi.connected_components(pages, conn)) / N3
        n_l = _equal_count(labels[:CCL_CPU_PAGES],
                           vi.connected_components(want_pages, conn))
        require(n_l == 0, f"ccl {conn}: {n_l} labels apart")
        n_obj = [int(torch.unique(labels[i]).numel()) for i in range(N3)]
        print(f"vision connected_components({conn}) on "
              f"{tuple(pages.shape)}: {ms:.4f} ms a page (one call), "
              f"{min(n_obj)}-{max(n_obj)} objects a page; pages "
              f"[:{CCL_CPU_PAGES}] vs the CPU: {n_l} of "
              f"{want_pages.numel()} labels apart [{name_limit}]")
    t0 = time.perf_counter()
    merged = [vi.relabel_sequential(vi.merge_small_components(
        vi.relabel_sequential(labels[i]), AREA_MIN, 8)) for i in range(N3)]
    torch.cuda.synchronize()
    merge_s = (time.perf_counter() - t0) / N3
    for i in range(CCL_CPU_PAGES):
        want = vi.relabel_sequential(vi.merge_small_components(
            vi.relabel_sequential(labels[i].cpu()), AREA_MIN, 8))
        require(torch.equal(merged[i].cpu(), want), f"merge page {i}")
    kept = [int(m.max()) + 1 for m in merged]
    reset_launches()
    ms = _call_ms(lambda: vi.area_threshold(pages, labels, AREA_MIN)) / N3
    n_a = _equal_count(vi.area_threshold(pages, labels, AREA_MIN)
                       [:CCL_CPU_PAGES],
                       vi.area_threshold(want_pages,
                                         labels[:CCL_CPU_PAGES].cpu(),
                                         AREA_MIN))
    require(n_a == 0 and sum(launched().values()) == 0,
            f"area threshold {n_a}")
    print(f"vision merge_small_components({AREA_MIN}, 8): {merge_s * 1e3:.1f} "
          f"ms a page on the host, {min(kept)}-{max(kept)} objects kept a "
          f"page; area_threshold {ms:.4f} ms a page; pages "
          f"[:{CCL_CPU_PAGES}] vs the CPU: merged labels equal, area "
          f"threshold {n_a} of {want_pages.numel()} px apart "
          f"[{name_limit}]")
    t0 = time.perf_counter()
    segs = [ft.hough_line_segments(pages[i], *PAGE_HOUGH) for i in range(N3)]
    hough_s = (time.perf_counter() - t0) / N3
    require(segs[0] == ft.hough_line_segments(want_pages[0], *PAGE_HOUGH),
            "hough segments page 0")
    print(f"vision hough_line_segments{PAGE_HOUGH} on {tuple(pages.shape)}: "
          f"{hough_s * 1e3:.1f} ms a page (host clock), "
          f"{min(map(len, segs))}-{max(map(len, segs))} lines a page; page 0 "
          f"vs the CPU: equal [{name_limit}]")
    return {"k3": k3}


def draw_phase(dev, gen, name_limit: str) -> None:
    """draw: MVG_1080 over N2 frames of 1080x1920x3 (coverage computed
    once, blended into each frame), frame 0 within DRAW_TOL of the CPU's
    float64 run; then annotate, frame, raise_image, oil_paint (radius 3),
    opaque_paint, transparent_paint and floodfill on the frames, frame 0
    equal to the CPU's.  None launches a kernel of the port's."""
    from imagemagick_tpu_torch.ops import decorate as dc
    from imagemagick_tpu_torch.ops import draw as dw
    from imagemagick_tpu_torch.ops import paint as pt

    frames = _scenes(gen, dev, N2)
    cpu0 = frames[:1].cpu()
    print(f"draw: text from {dw.loaded_font(None, 48)}")
    reset_launches()
    out = dw.draw(frames, MVG_1080)
    torch.cuda.synchronize()
    require(sum(launched().values()) == 0 and out.shape == frames.shape,
            f"draw {launched()} {out.shape}")
    ms = _once_ms(lambda: dw.draw(frames, MVG_1080)) / N2
    t0 = time.perf_counter()
    want = dw.draw(cpu0, MVG_1080)
    cpu_s = time.perf_counter() - t0
    err, n_off, n_px = _apart(out[:1], want, DRAW_TOL)
    require(err <= DRAW_TOL, f"draw max|d| {err}")
    n_ink = int(((out[0] - frames[0]).abs() > 1e-6).any(-1).sum())
    print(f"draw MVG (every primitive family) on {tuple(frames.shape)}: "
          f"{ms:.4f} ms an image (one call; the CPU's run of frame 0 "
          f"{cpu_s:.1f} s), {n_ink} px drawn; frame 0 vs the CPU: max|d| "
          f"{err:.3e}, {n_off} of {n_px} px apart by more than {DRAW_TOL} "
          f"[{name_limit}]")
    del out
    alpha = torch.cat([frames, torch.ones_like(frames[..., :1])], -1)
    seed_color = frames[0, 0, 0].tolist()
    calls = [
        ("annotate", lambda x: dw.annotate(x, "annotate 1080p", 40, 80,
                                           (0, 0, 0.5, 1), 48,
                                           gravity="south"), frames),
        ("frame", lambda x: dc.frame(x, 12, 12, 3, 3), frames),
        ("raise_image", lambda x: dc.raise_image(x, 20, 20), frames),
        ("oil_paint", lambda x: pt.oil_paint(x, 3.0), frames),
        ("opaque_paint", lambda x: pt.opaque_paint(
            x, seed_color, (1, 0, 0), FUZZ), frames),
        ("transparent_paint", lambda x: pt.transparent_paint(
            x, seed_color, 0.0, FUZZ), alpha),
        ("floodfill", lambda x: pt.floodfill(x, 0, 0, (0, 1, 0), FUZZ),
         frames)]
    for name, fn, x in calls:
        reset_launches()
        got = fn(x)
        torch.cuda.synchronize()
        require(sum(launched().values()) == 0, f"{name} {launched()}")
        ms = _once_ms(lambda: fn(x)) / N2
        n = _equal_count(got[:1], fn(x[:1].cpu()))
        require(n == 0, f"{name}: {n} values apart from the CPU")
        print(f"draw {name} on {tuple(x.shape)}: {ms:.4f} ms an image (one "
              f"call); frame 0 vs the CPU: {n} of {x[:1].numel()} values "
              f"apart [{name_limit}]")
        del got


def cli_vision_phase(dev, gen, name_limit: str) -> dict:
    """cli_vision: N3 scanned letter pages through CLI_VISION_PAGES (one
    K4 launch for the group's Otsu values; pages [:CCL_CPU_PAGES] equal to
    the CPU run), and N2 frames through CLI_VISION_FRAMES (one K1 launch
    for the group's resize, one K3 launch an image for Canny's blur): the
    resize within K1_TOL of the CPU's, Canny replayed on the CPU from the
    card's blur equal, the Hough lines replayed on the CPU from the card's
    edges equal, the whole CPU chain's pixels apart counted."""
    from imagemagick_tpu_torch.ops import blur as bl
    from imagemagick_tpu_torch.ops import enhance as en
    from imagemagick_tpu_torch.ops import feature as ft

    pages = list(_scans(gen, dev, N3))
    reset_launches()
    t0 = time.perf_counter()
    outs = _cli_run(CLI_VISION_PAGES, pages)
    wall = (time.perf_counter() - t0) / N3
    la = launched()
    require(la["k4"] == 1 and sum(la.values()) == 1,
            f"cli_vision pages launches {la}")
    k4 = la["k4"]
    want = _cli_run(CLI_VISION_PAGES, [p.cpu() for p in pages[:CCL_CPU_PAGES]])
    n = sum(_equal_count(o.data, w.data) for o, w in zip(outs, want))
    require(n == 0, f"cli_vision pages: {n} px apart")
    ids = [int(round(float(o.data.max()) * 65535)) + 1 for o in outs]
    print(f"cli_vision {' '.join(CLI_VISION_PAGES)} on {N3} pages of "
          f"{tuple(pages[0].shape)}: launches {la}, {wall * 1e3:.1f} ms a "
          f"page (one run, host clock), {min(ids)}-{max(ids)} objects a "
          f"page; pages [:{CCL_CPU_PAGES}] vs the CPU run: {n} px apart "
          f"[{name_limit}]")
    del outs, pages

    frames = list(_scenes(gen, dev, N2))
    reset_launches()
    outs = _cli_run(CLI_VISION_FRAMES, frames)
    la = launched()
    require(la["k1"] == 1 and la["k3"] == N2 and sum(la.values()) == 1 + N2,
            f"cli_vision frames launches {la}")
    ms = _call_ms(lambda: _cli_run(CLI_VISION_FRAMES, frames),
                  CLI_CALL_RUNS) / N2
    head = [o.data for o in _cli_run(CLI_VISION_FRAMES[:2], frames)]
    err = max_err(torch.stack(head).cpu(), torch.stack(
        [o.data for o in _cli_run(CLI_VISION_FRAMES[:2],
                                  [f.cpu() for f in frames])]))
    require(err <= K1_TOL, f"cli_vision resize max|d| {err}")
    edges = [o.data for o in _cli_run(CLI_VISION_FRAMES[:4], frames)]
    for h, e in zip(head, edges):
        smooth = bl.blur(en.grayscale(h), 0.0, 1.0)[..., 0].cpu()
        require(torch.equal(e[..., 0].cpu() > 0,
                            ft.canny_from_smooth(smooth, 0.1, 0.3)),
                "cli_vision canny replay")
    replay = _cli_run(CLI_VISION_FRAMES[4:], [e.cpu() for e in edges])
    require(all(torch.equal(o.data.cpu(), r.data)
                for o, r in zip(outs, replay)), "cli_vision hough replay")
    full = _cli_run(CLI_VISION_FRAMES, [f.cpu() for f in frames])
    apart = sum(_apart(o.data, f.data, 1e-6)[1] for o, f in zip(outs, full))
    n_px = sum(o.data[..., 0].numel() for o in outs)
    lines = [int((e > 0).sum()) for e in edges]
    print(f"cli_vision {' '.join(CLI_VISION_FRAMES)} on {N2} frames: "
          f"launches {la}, {ms:.4f} ms an image; resize vs the CPU max|d| "
          f"{err:.3e}; Canny replayed on the CPU from the card's blur and "
          f"the Hough lines from the card's edges: equal ({min(lines)}-"
          f"{max(lines)} edge px an image); the whole chain on the CPU: "
          f"{apart} of {n_px} px apart [{name_limit}]")
    return {"k1": la["k1"], "k3": la["k3"], "k4": k4}


def cli_draw_phase(dev, gen, name_limit: str) -> dict:
    """cli_draw: N2 frames through CLI_DRAW (one K1 launch for the group's
    resize; -draw, -annotate and -frame image by image): the resize
    within K1_TOL of the CPU's, the rest replayed on the CPU from the
    card's resize equal, the whole CPU chain of frame 0 counted."""
    frames = list(_scenes(gen, dev, N2))
    reset_launches()
    outs = _cli_run(CLI_DRAW, frames)
    la = launched()
    require(la["k1"] == 1 and sum(la.values()) == 1,
            f"cli_draw launches {la}")
    ms = _call_ms(lambda: _cli_run(CLI_DRAW, frames), CLI_CALL_RUNS) / N2
    head = [o.data for o in _cli_run(CLI_DRAW[:2], frames)]
    err = max_err(torch.stack(head).cpu(), torch.stack(
        [o.data for o in _cli_run(CLI_DRAW[:2], [f.cpu() for f in frames])]))
    require(err <= K1_TOL, f"cli_draw resize max|d| {err}")
    replay = _cli_run(CLI_DRAW[2:], [h.cpu() for h in head])
    n = sum(_equal_count(o.data, r.data) for o, r in zip(outs, replay))
    require(n == 0, f"cli_draw: {n} values apart from the replay")
    full = _cli_run(CLI_DRAW, [frames[0].cpu()])
    apart, n_px = _apart(outs[0].data, full[0].data, 1e-6)[1:]
    print(f"cli_draw {' '.join(CLI_DRAW)} on {N2} frames: launches {la}, "
          f"{ms:.4f} ms an image; resize vs the CPU max|d| {err:.3e}; the "
          f"rest replayed on the CPU from the card's resize: {n} values "
          f"apart; frame 0's whole chain on the CPU: {apart} of {n_px} px "
          f"apart by more than 1e-6 [{name_limit}]")
    return {"k1": la["k1"]}


def _rgba(frames: torch.Tensor) -> torch.Tensor:
    """frames with an alpha channel of their green blocks' levels."""
    return torch.cat([frames, frames[..., 1:2]], -1)


def _held(label: str, got: torch.Tensor, want: torch.Tensor,
          exact: bool = False) -> str:
    """Hold the card's ``got`` to the CPU's ``want``: equal where
    ``exact``, else within VFX_TOL but for at most SELECT_SHARE of the
    pixels (a histogram bin of a normalize, a selection)."""
    err, n_off, n_px = _apart(got, want, VFX_TOL)
    if exact:
        require(err == 0.0, f"{label}: max|d| {err}, not equal")
    require(n_off <= SELECT_SHARE * n_px, f"{label}: {n_off} px apart")
    return f"max|d| {err:.3e}, {n_off} of {n_px} px apart by more than " \
        f"{VFX_TOL}"


def visual_effects_phase(dev, gen, name_limit: str) -> dict:
    """visual_effects: every effect of ``ops/visual_effects.py`` on N2
    frames of 1080x1920x3 (shadow and polaroid on RGBA), with the launch
    counts set to 0 just before each (one K3 launch for VFX_K3, none for
    the rest), its median ms an image over VFX_RUNS calls, and frame 0 (a
    VFX_CROP crop where marked) against the CPU.  The noise types and the
    sketch draw their variates on the card; the card's and the CPU's
    deterministic halves run on the same variates."""
    from imagemagick_tpu_torch.ops import visual_effects as vfx

    frames = _scenes(gen, dev, N2)
    rgba = _rgba(frames)
    ch, cw = VFX_CROP
    wm = frames.flip(0)[0]
    sketch_val = vfx.sketch_variates(frames, gen)
    effects = [
        ("blue_shift", lambda x: vfx.blue_shift(x, 1.5), frames, False),
        ("charcoal", lambda x: vfx.charcoal(x, 0.0, 1.0), frames, False),
        ("colorize", lambda x: vfx.colorize(x, (0.9, 0.4, 0.1), 0.3),
         frames, False),
        ("color_matrix", lambda x: vfx.color_matrix(x, np.array(
            [[0.5, 0.3, 0.2], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6]])),
         frames, False),
        ("sepia_tone", lambda x: vfx.sepia_tone(x, 0.8), frames, False),
        ("solarize", lambda x: vfx.solarize(x, 0.5), frames, False),
        ("stegano", lambda x: vfx.stegano(x, wm.to(x.device)), frames,
         False),
        ("stereo", lambda x: vfx.stereo(x, x.flip(-2), 12, 4), frames,
         False),
        ("tint", lambda x: vfx.tint(x, (1.0, 0.5, 0.0), (60.0,)), frames,
         False),
        ("vignette", lambda x: vfx.vignette(x, 0.0, 10.0), frames, False),
        ("wavelet_denoise", lambda x: vfx.wavelet_denoise(x, 0.05, 0.0),
         frames, False),
        ("sketch", lambda x: vfx.sketch_from(
            x, sketch_val[:x.shape[0], :2 * x.shape[1], :2 * x.shape[2]]
            .to(x.device), 0.0, 1.0, 30.0), frames, True),
        ("shadow", lambda x: vfx.shadow(x, 80.0, 3.0, 5, 5), rgba, False),
        ("polaroid", lambda x: vfx.polaroid(x, 8.0), rgba, True)]
    k3 = 0
    for name, fn, x, crop in effects:
        reset_launches()
        out = fn(x)
        torch.cuda.synchronize()
        la = launched()
        want_k3 = 1 if name in VFX_K3 else 0
        require(la["k3"] == want_k3 and sum(la.values()) == want_k3,
                f"visual_effects {name} launches {la}")
        k3 += la["k3"]
        require(bool(torch.isfinite(out).all()), f"{name} not finite")
        shape = tuple(out.shape)
        del out
        ms = _call_ms(lambda: fn(x), runs=VFX_RUNS) / N2
        x0 = x[:1, :ch, :cw] if crop else x[:1]
        t0 = time.perf_counter()
        want = fn(x0.cpu())
        cpu_s = time.perf_counter() - t0
        held = _held(name, fn(x0), want, name in VFX_EXACT)
        print(f"visual_effects {name} on {tuple(x.shape)} -> {shape}: "
              f"launches {la}; {ms:.4f} ms an image (median of {VFX_RUNS});"
              f" {'a %dx%d crop of ' % VFX_CROP if crop else ''}frame 0 vs "
              f"the CPU ({cpu_s:.1f} s there): {held} [{name_limit}]")
    for kind in NOISE_TYPES:
        reset_launches()
        vs = vfx.noise_variates(frames, kind, 1.0, gen)
        out = vfx.add_noise_from(frames, kind, 1.0, vs)
        torch.cuda.synchronize()
        require(sum(launched().values()) == 0 and
                bool(torch.isfinite(out).all()), f"noise {kind}")
        mean_shift = float((out - frames).mean())
        del out
        ms = _call_ms(lambda: vfx.add_noise(frames, kind, 1.0, gen),
                      runs=VFX_RUNS) / N2
        held = _held(f"noise {kind}", vfx.add_noise_from(
            frames[:1], kind, 1.0, [v[:1] for v in vs]),
            vfx.add_noise_from(frames[:1].cpu(), kind, 1.0,
                               [v[:1].cpu() for v in vs]))
        print(f"visual_effects add_noise({kind}) on {tuple(frames.shape)}: "
              f"{ms:.4f} ms an image with its draw (median of {VFX_RUNS}), "
              f"mean change {mean_shift:.3e}; frame 0 vs the CPU on the "
              f"card's variates: {held} [{name_limit}]")
        del vs
    return {"k3": k3}


def _animation(gen, dev) -> list:
    """LAYER_N frames of a GIF export as the port's Images: frame 0 the
    whole H x W x 4 background with the sprite, each later frame the box
    that changed (the sprite's old and new places) at its page offset,
    the sprite standing still at LAYER_PAUSES (a repeated frame)."""
    from imagemagick_tpu_torch.core.image import Image
    from imagemagick_tpu_torch.core.spec import ImageSpec

    spec = ImageSpec(colorspace="srgb", alpha=True)
    bg = _rgba(_scenes(gen, dev, 1)[0, :H, :W])
    bg[..., 3] = 1.0
    sh, sw = SPRITE
    yy = torch.arange(sh, device=dev)[:, None] / sh - 0.5
    xx = torch.arange(sw, device=dev)[None, :] / sw - 0.5
    disk = (1.0 - 4.0 * (yy * yy + xx * xx)).clamp(0.0, 1.0)
    sprite = torch.stack([disk, 0.3 * disk + 0.2, 1.0 - disk,
                          (disk * 2.0).clamp(max=1.0)], -1)
    places, y, x = [], 20, 10
    for k in range(LAYER_N):
        if k not in LAYER_PAUSES:
            y, x = (y + 17) % (H - sh), (x + 29) % (W - sw)
        places.append((y, x))

    def over(canvas, y, x):
        out = canvas.clone()
        a = sprite[..., 3:]
        win = out[y:y + sh, x:x + sw]
        win[..., :3] = sprite[..., :3] * a + win[..., :3] * (1.0 - a)
        return out

    frames = [Image(over(bg, *places[0]), spec, delay=LAYER_DELAY)]
    for k in range(1, LAYER_N):
        (y0, x0), (y1, x1) = places[k - 1], places[k]
        top, left = min(y0, y1), min(x0, x1)
        bottom, right = max(y0, y1) + sh, max(x0, x1) + sw
        full = over(bg, y1, x1)
        delay = 0 if k - 1 in LAYER_PAUSES else LAYER_DELAY
        frames.append(Image(full[top:bottom, left:right].contiguous(), spec,
                            page=(left, top, W, H), delay=delay))
    return frames


def _frames_apart(label: str, got, want, tol: float = VFX_TOL) -> str:
    """Hold two lists of the port's Images: equal counts, pages, delays
    and shapes, pixels within ``tol``."""
    require(len(got) == len(want), f"{label}: {len(got)} != {len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        require((g.page, g.delay, tuple(g.data.shape)) ==
                (w.page, w.delay, tuple(w.data.shape)),
                f"{label}: {g.page} {g.delay} {tuple(g.data.shape)} != "
                f"{w.page} {w.delay} {tuple(w.data.shape)}")
        worst = max(worst, float((g.data.cpu() - w.data).abs().max()))
    require(worst <= tol, f"{label}: max|d| {worst}")
    return f"{len(got)} frame(s), pages, delays and shapes equal, max|d| " \
        f"{worst:.3e}"


def layers_phase(dev, gen, name_limit: str) -> None:
    """layers: the LAYER_N-frame GIF export of ``_animation`` through each
    layer operator on the card, ms a frame (median of VFX_RUNS), held to
    the same call on CPU copies; then the contact sheet, ``montage`` of
    CLI_N2 images of 512x768x3 on a MONTAGE_TILE grid of
    MONTAGE_GEOMETRY, against the CPU.  None launches a kernel."""
    from imagemagick_tpu_torch.core.image import Image
    from imagemagick_tpu_torch.core.spec import ImageSpec
    from imagemagick_tpu_torch.ops import layer as ly
    from imagemagick_tpu_torch.ops import montage as mo

    frames = _animation(gen, dev)
    cpu = [Image(f.data.cpu(), f.spec, page=f.page, delay=f.delay)
           for f in frames]
    bg = (1.0, 1.0, 1.0, 1.0)
    coalesced = ly.coalesce(frames)
    coalesced_cpu = ly.coalesce(cpu)
    calls = [
        ("coalesce", lambda fr, co: ly.coalesce(fr), False),
        ("optimize", lambda fr, co: ly.optimize_layers(fr), False),
        ("optimize-transparency",
         lambda fr, co: ly.optimize_transparency(fr), False),
        ("remove-dups", lambda fr, co: ly.remove_duplicate_layers(co), True),
        ("remove-zero", lambda fr, co: ly.remove_zero_delay_layers(co), True),
        ("deconstruct", lambda fr, co: ly.deconstruct(co), True),
        ("flatten", lambda fr, co: [ly.flatten(fr, bg)], False),
        ("mosaic", lambda fr, co: [ly.mosaic(fr, bg)], False),
        ("append", lambda fr, co: [ly.append(co, True, bg)], True),
        ("smush", lambda fr, co: [ly.smush(fr[1:], False, 4, bg)], False)]
    for name, fn, on_coalesced in calls:
        reset_launches()
        out = fn(frames, coalesced)
        torch.cuda.synchronize()
        require(sum(launched().values()) == 0, f"layers {name} {launched()}")
        ms = _call_ms(lambda: fn(frames, coalesced), runs=VFX_RUNS) / LAYER_N
        held = _frames_apart(name, out, fn(cpu, coalesced_cpu))
        print(f"layers {name} on {LAYER_N} frames of {(H, W, 4)} "
              f"{'(coalesced) ' if on_coalesced else ''}-> "
              f"{tuple(out[0].data.shape)}: {ms:.4f} ms a frame (median of "
              f"{VFX_RUNS}); vs the CPU: {held} [{name_limit}]")
        del out

    spec = ImageSpec(colorspace="srgb")
    sheet = [Image(d, spec) for d in
             torch.rand((CLI_N2, H, W, C), generator=gen, device=dev)]
    reset_launches()
    out = mo.montage(sheet, MONTAGE_TILE, MONTAGE_GEOMETRY)
    torch.cuda.synchronize()
    require(sum(launched().values()) == 0, f"montage {launched()}")
    ms = _call_ms(lambda: mo.montage(sheet, MONTAGE_TILE, MONTAGE_GEOMETRY),
                  runs=VFX_RUNS) / CLI_N2
    want = mo.montage([Image(i.data.cpu(), spec) for i in sheet],
                      MONTAGE_TILE, MONTAGE_GEOMETRY)
    held = _frames_apart("montage", [out], [want])
    print(f"layers montage of {CLI_N2} x {(H, W, C)} on {MONTAGE_TILE} "
          f"{MONTAGE_GEOMETRY} -> {tuple(out.data.shape)}: {ms:.4f} ms an "
          f"image (median of {VFX_RUNS}); vs the CPU: {held} [{name_limit}]")


def _polar(mag: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """The complex values that a -fft magnitude and phase pair encodes."""
    return torch.polar(mag.double(), 2.0 * math.pi * (phase.double() - 0.5))


def cli_layers_phase(dev, gen, name_limit: str) -> dict:
    """cli_layers: CLI_N2 images of 512x768x3 through each chain of
    CLI_LAYERS (one K1 launch for the group's resize; the K3 launches an
    image that the chain names): the resize within K1_TOL of the CPU's,
    the rest replayed on the CPU from the card's resize (within VFX_TOL
    but for SELECT_SHARE of the pixels; -fft's pairs as complex values
    within VFX_TOL of max|F|), ms an image."""
    datas = list(torch.rand((CLI_N2, H, W, C), generator=gen, device=dev))
    k1 = k3 = 0
    for argv, k3_each in CLI_LAYERS:
        reset_launches()
        outs = _cli_run(argv, datas)
        la = launched()
        require(la["k1"] == 1 and la["k3"] == k3_each * CLI_N2 and
                sum(la.values()) == 1 + k3_each * CLI_N2,
                f"cli_layers {argv} launches {la}")
        k1 += la["k1"]
        k3 += la["k3"]
        ms = _call_ms(lambda: _cli_run(argv, datas), runs=VFX_RUNS) / CLI_N2
        head = [o.data for o in _cli_run(argv[:2], datas)]
        err = max_err(torch.stack(head).cpu(), torch.stack(
            [o.data for o in _cli_run(argv[:2], [d.cpu() for d in datas])]))
        require(err <= K1_TOL, f"cli_layers resize max|d| {err}")
        replay = _cli_run(argv[2:], [h.cpu() for h in head])
        require(len(replay) == len(outs), f"cli_layers {len(outs)} outputs")
        pairs = list(zip(outs, replay))
        if argv[-1] == "-fft":
            # a phase is held through the complex value it encodes: where
            # |F| is tiny its angle means nothing
            for (m, r), (p, q) in zip(pairs[::2], pairs[1::2]):
                f, g = _polar(m.data.cpu(), p.data.cpu()), \
                    _polar(r.data, q.data)
                rel = float((f - g).abs().max() / g.abs().max())
                require(rel <= VFX_TOL, f"cli_layers -fft: {rel}")
            pairs = pairs[::2]
        held = [_held(" ".join(argv), o.data, r.data) for o, r in pairs][0]
        print(f"cli_layers {' '.join(argv)} on {CLI_N2} images: launches "
              f"{la}, {len(outs)} output(s) of {tuple(outs[0].data.shape)}, "
              f"{ms:.4f} ms an image (median of {VFX_RUNS}); resize vs the "
              f"CPU max|d| {err:.3e}; the rest replayed on the CPU from the "
              f"card's resize (output 0): {held} [{name_limit}]")
    return {"k1": k1, "k3": k3}


def _smooth_u8(rng, n: int, h: int, w: int, c: int) -> np.ndarray:
    """n photo-like u8 images from ``rng``: a smooth shading per image,
    flat blocks and a little noise (PNG compresses them as it would a
    photo, unlike uniform noise)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((n, h, w, c), np.uint8)
    for k in range(n):
        fy, fx = rng.uniform(20, 90, 2)
        ph = rng.uniform(0, 6.3, c).astype(np.float32)
        img = 0.5 + 0.35 * np.sin(yy / fy)[..., None] * np.cos(
            xx[..., None] / fx + ph)
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        img[y0:y0 + h // 5, x0:x0 + w // 6] = rng.uniform(0.1, 0.9)
        img += rng.normal(0, 0.02, img.shape).astype(np.float32)
        out[k] = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    return out


def _host_ms(fn, runs: int = IO_RUNS) -> tuple:
    """Median wall ms of ``fn`` (the card synchronized after each run)
    over ``runs`` runs after a warm-up, and its last result."""
    out = fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def _share_apart(a: np.ndarray, b: np.ndarray, levels: int = 1) -> float:
    """The share of samples more than ``levels`` u8 levels apart."""
    return float(np.mean(np.abs(a.astype(np.int64) - b) > levels))


def io_phase(dev, gen, name_limit: str, seed: int) -> None:
    """io: one 1080x1920x3 image from ``seed`` encoded with PIL as PNG,
    JPEG (quality 90) and PPM, and as raw RGB samples; each decoded onto
    the card (``image_from_blob``, ``read_images`` with -size for raw),
    equal bit for bit to the same decode on the CPU, and encoded from the
    card (``image_to_blob``) to the CPU's bytes; ms an image each."""
    import tempfile

    from PIL import Image as PImage

    from imagemagick_tpu_torch import io as tio

    arr = _smooth_u8(np.random.default_rng(seed + 7), 1, IO_H, IO_W, C)[0]
    blobs = {}
    for fmt, pil in (("png", "PNG"), ("jpeg", "JPEG"), ("ppm", "PPM")):
        buf = io.BytesIO()
        PImage.fromarray(arr).save(buf, pil, **(
            {"quality": 90} if pil == "JPEG" else {}))
        blobs[fmt] = buf.getvalue()
    with tempfile.TemporaryDirectory() as td:
        raw = os.path.join(td, "frame.rgb")
        with open(raw, "wb") as f:
            f.write(arr.tobytes())
        size = f"{IO_W}x{IO_H}"
        for fmt in ("png", "jpeg", "ppm", "rgb"):
            if fmt == "rgb":
                def decode(d=dev):
                    return tio.read_images(raw, size=size, device=d)[0]
            else:
                def decode(d=dev, fmt=fmt):
                    return tio.image_from_blob(blobs[fmt], fmt, device=d)[0]
            dec_ms, img = _host_ms(decode)
            want = decode("cpu")
            require(img.data.device == torch.device(dev) and
                    torch.equal(img.data.cpu(), want.data),
                    f"io {fmt}: the card's decode is not the CPU's")
            enc_ms, blob = _host_ms(lambda: tio.image_to_blob(
                img, fmt, quality=90))
            require(blob == tio.image_to_blob(want, fmt, quality=90),
                    f"io {fmt}: the card's encode is not the CPU's")
            nbytes = len(blobs.get(fmt, b"")) or os.path.getsize(raw)
            print(f"io {fmt} {IO_H}x{IO_W}x{C} ({nbytes} bytes): decode to "
                  f"the card {dec_ms:.4f} ms, encode from it {enc_ms:.4f} ms "
                  f"(median of {IO_RUNS}); equal to the CPU's decode and "
                  f"bytes [{name_limit}]")


def _main_ok(argv, device) -> None:
    from imagemagick_tpu_torch.cli.main import main as cli_main

    rc = cli_main(list(argv), device=device)
    require(rc == 0, f"main {argv[-6:]} returned {rc}")
    torch.cuda.synchronize()


def cli_files_phase(dev, gen, name_limit: str, seed: int) -> dict:
    """cli_files: CLI_FILES_N PNGs of 512x768x3 through config #1's chain
    to ``out-%d.png`` by ``main(..., device="cuda")`` (one K1 launch for
    the group), against the same run on the CPU (decoded samples within
    one level on at least 99.9 % of them); images/s and the per-image
    marginal between CLI_FILES_N1 and CLI_FILES_N images; then
    CLI_FILES_PAGES PGM pages of 1056x816 through config #3's chain to
    ``page-%d.pbm`` (one K4 launch), against the CPU run."""
    import tempfile

    from PIL import Image as PImage

    rng = np.random.default_rng(seed + 8)
    with tempfile.TemporaryDirectory() as td:
        pngs = []
        for k, a in enumerate(_smooth_u8(rng, CLI_FILES_N, H, W, C)):
            pngs.append(os.path.join(td, f"in{k}.png"))
            PImage.fromarray(a).save(pngs[-1])
        out = os.path.join(td, "out")
        reset_launches()
        _main_ok(pngs + CLI_ARGV + [out + "-%d.png"], dev)
        la1 = launched()
        require(la1["k1"] == 1 and sum(la1.values()) == 1,
                f"cli_files config #1 launches {la1}")
        _main_ok(pngs + CLI_ARGV + [out + "-cpu-%d.png"], "cpu")
        apart = 0.0
        for k in range(CLI_FILES_N):
            a = np.asarray(PImage.open(f"{out}-{k}.png"))
            b = np.asarray(PImage.open(f"{out}-cpu-{k}.png"))
            require(a.shape == b.shape == (HOUT, WOUT),
                    f"cli_files output {k} {a.shape}")
            apart = max(apart, _share_apart(a, b))
        require(apart <= 1e-3, f"cli_files config #1: {apart} apart")

        def run(paths):
            _main_ok(paths + CLI_ARGV + [out + f"-{len(paths)}-%d.png"],
                     dev)

        wall = min(_once_ms(lambda: run(pngs)) for _ in range(2))
        per, margs = _marginal(run, pngs, CLI_FILES_N1, CLI_FILES_N,
                               rounds=CLI_FILES_ROUNDS)
        print(f"cli_files config #1: {CLI_FILES_N} PNGs of {H}x{W}x{C} -> "
              f"out-%d.png in one K1 launch {la1}; {wall:.4f} ms = "
              f"{CLI_FILES_N / wall * 1e3:.2f} images/s (best of 2); "
              f"marginal ({CLI_FILES_N}-{CLI_FILES_N1} files, median of "
              f"{CLI_FILES_ROUNDS}) {per * 1e3:.4f} ms an image; rounds "
              f"{[round(m * 1e3, 4) for m in margs]} ms; samples more than "
              f"one level from the CPU run: {apart:.2e} [{name_limit}]")

        pgms = []
        for k in range(CLI_FILES_PAGES):
            pgms.append(os.path.join(td, f"page{k}.pgm"))
            page = _page_u8(rng)
            PImage.fromarray(page, "L").save(pgms[-1])
        reset_launches()
        t0 = time.perf_counter()
        _main_ok(pgms + CLI_PAGES + [out + "-page-%d.pbm"], dev)
        page_wall = (time.perf_counter() - t0) * 1e3
        la3 = launched()
        require(la3["k4"] == 1 and la3["k1"] == 0,
                f"cli_files config #3 launches {la3}")
        _main_ok(pgms + CLI_PAGES + [out + "-cpu-page-%d.pbm"], "cpu")
        diff = 0.0
        for k in range(CLI_FILES_PAGES):
            a = np.asarray(PImage.open(f"{out}-page-{k}.pbm"))
            b = np.asarray(PImage.open(f"{out}-cpu-page-{k}.pbm"))
            require(a.shape == b.shape == (H3, W3), f"page {k} {a.shape}")
            diff = max(diff, float(np.mean(a != b)))
        require(diff <= 1e-3, f"cli_files config #3: {diff} apart")
        print(f"cli_files config #3: {CLI_FILES_PAGES} PGM pages of "
              f"{H3}x{W3} -> page-%d.pbm, launches {la3}; {page_wall:.4f} "
              f"ms = {page_wall / CLI_FILES_PAGES:.4f} ms a page (first "
              f"run); pixels apart from the CPU run: {diff:.2e} "
              f"[{name_limit}]")
    return {"k1": la1["k1"], "k4": la3["k4"]}


def _page_u8(rng) -> np.ndarray:
    """A letter page of H3 x W3: light paper, lines of dark strokes and
    scanner noise, u8."""
    page = 0.9 + 0.03 * rng.standard_normal((H3, W3))
    for y in range(60, H3 - 60, 24):
        x = 60
        while x < W3 - 80:
            n = int(rng.integers(6, 40))
            page[y:y + 10, x:x + n] = rng.uniform(0.05, 0.3)
            x += n + int(rng.integers(4, 14))
    return (np.clip(page, 0, 1) * 255 + 0.5).astype(np.uint8)


def serve_convert_phase(dev, gen, name_limit: str, seed: int) -> dict:
    """serve_convert: ``make_server(port=0)`` on the card, POST /convert
    of a 1080x1920 JPEG with config #1's chain and ``of=jpeg`` (one K1
    launch a request, the result within one level of the same request
    run on the CPU on at least 99.9 % of the samples), the request's wall
    beside its parts timed apart (host decode, upload, K1, download, host
    encode), SERVE_CONVERT_CLIENTS clients at once, and /identify and
    /formats."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from http.client import HTTPConnection
    from urllib.parse import quote

    from PIL import Image as PImage

    from imagemagick_tpu_torch import io as tio
    from imagemagick_tpu_torch import serve
    from imagemagick_tpu_torch.cli import main as cm
    from imagemagick_tpu_torch.io import codecs

    arr = _smooth_u8(np.random.default_rng(seed + 9), 1, IO_H, IO_W, C)[0]
    buf = io.BytesIO()
    PImage.fromarray(arr).save(buf, "JPEG", quality=90)
    body = buf.getvalue()
    args = quote(" ".join(CLI_ARGV))
    srv = serve.make_server(port=0, device=dev)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]

    def call(method, path, data=None) -> bytes:
        conn = HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            conn.request(method, path, body=data)
            resp = conn.getresponse()
            out = resp.read()
        finally:
            conn.close()
        require(resp.status == 200, f"{method} {path}: {resp.status} "
                f"{out[:300]!r}")
        return out

    def convert() -> bytes:
        return call("POST", f"/convert?args={args}&of=jpeg", body)

    try:
        convert()                                # plan and operands
        walls, k1 = [], 0
        for _ in range(SERVE_CONVERT_REQUESTS):
            reset_launches()
            t0 = time.perf_counter()
            got = convert()
            walls.append((time.perf_counter() - t0) * 1e3)
            la = launched()
            require(la["k1"] == 1 and sum(la.values()) == 1,
                    f"serve_convert launches {la}")
            k1 += la["k1"]
        n_req = SERVE_CLIENTS * SERVE_CONVERT_ROUNDS
        with ThreadPoolExecutor(SERVE_CLIENTS) as ex:
            t0 = time.perf_counter()
            list(ex.map(lambda _: convert(), range(n_req)))
            together = time.perf_counter() - t0
        text = call("POST", "/identify", body).decode()
        require(f"Geometry: {IO_W}x{IO_H}+0+0" in text,
                f"serve /identify {text[:200]!r}")
        formats = json.loads(call("GET", "/formats"))
        require("jpeg" in formats["read"] and "png" in formats["write"],
                f"serve /formats {formats}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    want = serve._run_cli(["-", *CLI_ARGV, "jpeg:-"], body, "cpu")
    a = np.asarray(PImage.open(io.BytesIO(got)))
    b = np.asarray(PImage.open(io.BytesIO(want)))
    require(a.shape == b.shape == (HOUT, WOUT), f"serve_convert {a.shape}")
    apart = _share_apart(a, b)
    require(apart <= 1e-3, f"serve_convert: {apart} apart from the CPU")

    # the request's parts, timed apart on the same body
    def decode():
        return codecs.decode(body, "jpeg", device="cpu")[0]

    def upload(img):
        return img.data.to(dev)

    def kernel(x):
        from imagemagick_tpu_torch.core.image import Image as TImage

        st = cm.CLIState(device=dev)
        st.images.append(cm.LazyImage(TImage(x, decoded.spec)))
        cm.process(list(CLI_ARGV), st)
        return st.images[0].materialize()

    decoded = decode()
    parts = {"decode": _host_ms(decode)[0]}
    parts["upload"], x = _host_ms(lambda: upload(decoded))
    parts["kernel"], y = _host_ms(lambda: kernel(x))
    parts["download"], host = _host_ms(lambda: y.data.cpu())
    from imagemagick_tpu_torch.core.image import Image as TImage

    out_img = TImage(host, y.spec)
    parts["encode"] = _host_ms(lambda: tio.image_to_blob(out_img, "jpeg"))[0]
    per = statistics.median(walls)
    split = ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
    print(f"serve_convert: POST /convert of a {IO_H}x{IO_W} JPEG "
          f"({len(body)} bytes) through {' '.join(CLI_ARGV)} of=jpeg, one "
          f"K1 launch a request; request wall median of "
          f"{SERVE_CONVERT_REQUESTS} {per:.4f} ms; its parts apart (ms, "
          f"median of {IO_RUNS}): {split}, sum "
          f"{sum(parts.values()):.4f}; samples more than one level from the "
          f"CPU run: {apart:.2e} [{name_limit}]")
    print(f"serve_convert, {SERVE_CLIENTS} clients at once: {n_req} "
          f"requests in {together * 1e3:.4f} ms = "
          f"{n_req / together:.2f} requests/s; /identify and /formats "
          f"answered [{name_limit}]")
    return {"k1": k1}


def io_coders_phase(dev, gen, name_limit: str, seed: int) -> dict:
    """io_coders: the second slice's coders at 1080p (each decode onto the
    card held to the CPU's, each encode from the card to the CPU's bytes,
    ms an image) and ``cli.main.main`` from MIFF files: the CLI_CODERS
    chain to EXR (one K1 launch), -auto-threshold otsu on 16-bit pages
    (one K4 launch) and -remap under two dithers (one K1 launch each)."""
    import tempfile

    from PIL import Image as PImage

    from imagemagick_tpu_torch import io as tio
    from imagemagick_tpu_torch import native
    from imagemagick_tpu_torch.core.image import Image as TImage
    from imagemagick_tpu_torch.core.spec import ImageSpec
    from imagemagick_tpu_torch.io import dng as tdng
    from imagemagick_tpu_torch.io import exr as texr
    from imagemagick_tpu_torch.io import miff as tmiff

    rng = np.random.default_rng(seed + 10)
    arr = _smooth_u8(rng, 1, IO_H, IO_W, C)[0]
    src = TImage(arr.astype(np.float32) / 255.0, device="cpu")
    card_src = TImage(src.data.to(dev), src.spec)
    encoders = {
        "miff 8-bit zip": lambda im: tmiff.encode([im], 8, "zip"),
        "miff 16-bit zip": lambda im: tmiff.encode([im], 16, "zip"),
        "exr half zip": lambda im: texr.encode(im, True, "zip"),
        "exr float zip": lambda im: texr.encode(im, False, "zip"),
        "farbfeld": lambda im: tio.image_to_blob(im, "ff"),
        "dng 16-bit rggb": lambda im: tio.image_to_blob(im, "dng"),
    }
    with tempfile.TemporaryDirectory() as td:
        mpc_path = os.path.join(td, "frame.mpc")
        tio.write_image(src, mpc_path)

        def write_mpc(im):
            out = os.path.join(td, "out.mpc")
            tio.write_image(im, out)
            with open(out, "rb") as f:
                return f.read()

        encoders["mpc"] = write_mpc
        for name, encode in encoders.items():
            blob = encode(src)
            if name == "mpc":
                def decode(d=dev):
                    return tio.read_images(mpc_path, device=d)[0]
            else:
                def decode(d=dev, b=blob):
                    return tio.image_from_blob(b, device=d)[0]
            dec_ms, img = _host_ms(decode, CODER_RUNS)
            want = decode("cpu")
            require(img.data.device == torch.device(dev) and
                    img.data.shape == want.data.shape,
                    f"io_coders {name}: decoded to {img.data.device}")
            if name.startswith("dng"):
                err = max_err(img.data.cpu(), want.data)
                require(err <= DNG_TOL, f"io_coders {name}: max|d| {err}")
                held = f"within {err:.3e} of the CPU's decode (bound " \
                    f"{DNG_TOL})"
            else:
                require(torch.equal(img.data.cpu(), want.data),
                        f"io_coders {name}: the card's decode is not the "
                        f"CPU's")
                held = "equal to the CPU's decode"
            enc_ms, got = _host_ms(lambda: encode(card_src), CODER_RUNS)
            require(got == blob, f"io_coders {name}: the card's encode is "
                    f"not the CPU's")
            print(f"io_coders {name} {IO_H}x{IO_W}x{C} ({len(blob)} bytes): "
                  f"decode to the card {dec_ms:.4f} ms, encode from it "
                  f"{enc_ms:.4f} ms (median of {CODER_RUNS} after a "
                  f"warm-up, host clock); {held}, the encode's bytes the "
                  f"CPU's [{name_limit}]")

        # the demosaic alone, on a CFA of the frame's extent
        cfa = rng.random((IO_H, IO_W), dtype=np.float32)
        pat = np.asarray([[0, 1], [1, 2]], np.int64)
        wb = np.asarray([1.9, 1.0, 1.4], np.float32)
        ms, dem = _host_ms(lambda: tdng._demosaic_bilinear(cfa, pat, wb,
                                                           dev), CODER_RUNS)
        err = max_err(dem.cpu(), tdng._demosaic_bilinear(cfa, pat, wb,
                                                         "cpu"))
        require(err <= DNG_DEMOSAIC_TOL, f"io_coders demosaic max|d| {err}")
        print(f"io_coders dng demosaic {IO_H}x{IO_W} on the card: "
              f"{ms:.4f} ms with its upload (median of {CODER_RUNS} after a "
              f"warm-up), max|d| {err:.3e} from the CPU's (bound "
              f"{DNG_DEMOSAIC_TOL}, TF32 off) [{name_limit}]")

        # MIFF frames through the CLI: K1, to EXR
        frames = []
        for k, a in enumerate(_smooth_u8(rng, CODER_FRAMES, IO_H, IO_W, C)):
            frames.append(os.path.join(td, f"frame{k}.miff"))
            with open(frames[-1], "wb") as f:
                f.write(tio.image_to_blob(TImage(
                    a.astype(np.float32) / 255.0, device="cpu"), "miff"))
        out = os.path.join(td, "out")
        reset_launches()
        t0 = time.perf_counter()
        _main_ok(frames + CLI_CODERS + [out + "-%d.exr"], dev)
        wall = (time.perf_counter() - t0) * 1e3
        la1 = launched()
        require(la1["k1"] == 1 and sum(la1.values()) == 1,
                f"io_coders MIFF chain launches {la1}")
        _main_ok(frames + CLI_CODERS + [out + "-cpu-%d.exr"], "cpu")
        err = 0.0
        for k in range(CODER_FRAMES):
            a, b = (tio.read_images(f"{out}{side}-{k}.exr", device="cpu")[0]
                    .data for side in ("", "-cpu"))
            require(a.shape == b.shape == (IO_H // 2, IO_W // 2, 1),
                    f"io_coders EXR output {k} {tuple(a.shape)}")
            err = max(err, max_err(a, b))
        require(err <= EXR_HALF_TOL, f"io_coders MIFF chain max|d| {err}")
        print(f"io_coders cli: {CODER_FRAMES} MIFF frames of {IO_H}x{IO_W}x"
              f"{C} -> {' '.join(CLI_CODERS)} -> out-%d.exr (half, zip) by "
              f"main(..., device='cuda'): launches {la1}, {wall:.4f} ms "
              f"({wall / CODER_FRAMES:.4f} ms an image, first run); max|d| "
              f"{err:.3e} from the CPU run [{name_limit}]")

        # 16-bit MIFF pages through -auto-threshold otsu: K4, to PBM
        pages = []
        for k in range(CODER_PAGES):
            pages.append(os.path.join(td, f"page{k}.miff"))
            page = TImage(_page_u8(rng)[..., None].astype(np.float32) / 255,
                          ImageSpec(colorspace="gray", depth=16),
                          device="cpu")
            with open(pages[-1], "wb") as f:
                f.write(tio.image_to_blob(page, "miff"))
        argv = ["-auto-threshold", "otsu"]
        reset_launches()
        t0 = time.perf_counter()
        _main_ok(pages + argv + [out + "-page-%d.pbm"], dev)
        wall = (time.perf_counter() - t0) * 1e3
        la4 = launched()
        require(la4["k4"] == 1 and sum(la4.values()) == 1,
                f"io_coders MIFF pages launches {la4}")
        _main_ok(pages + argv + [out + "-cpu-page-%d.pbm"], "cpu")
        diff = 0.0
        for k in range(CODER_PAGES):
            a = np.asarray(PImage.open(f"{out}-page-{k}.pbm"))
            b = np.asarray(PImage.open(f"{out}-cpu-page-{k}.pbm"))
            require(a.shape == b.shape == (H3, W3), f"page {k} {a.shape}")
            diff = max(diff, float(np.mean(a != b)))
        require(diff <= 1e-3, f"io_coders pages: {diff} apart")
        print(f"io_coders cli: {CODER_PAGES} 16-bit MIFF pages of {H3}x{W3} "
              f"-> -auto-threshold otsu -> page-%d.pbm: launches {la4}, "
              f"{wall:.4f} ms (first run); pixels apart from the CPU run: "
              f"{diff:.2e} [{name_limit}]")

        # -remap under a dither: the card's resize, the host's octree
        pal_path = os.path.join(td, "pal.png")
        PImage.fromarray(np.asarray([REMAP_PALETTE], np.uint8)).save(
            pal_path)
        pal = np.asarray(REMAP_PALETTE, np.float32) / np.float32(255)
        frame = tio.read_images(frames[0], device=dev)[0]
        resized = _cli_run(["-resize", "50%"], [frame.data], frame.spec)[0]
        k1_remap = 0
        for dither, key in (("Riemersma", "riemersma"),
                            ("FloydSteinberg", "fs")):
            target = f"{out}-remap-{key}.png"
            reset_launches()
            t0 = time.perf_counter()
            _main_ok([frames[0], "-resize", "50%", "-dither", dither,
                      "-remap", pal_path, target], dev)
            wall = (time.perf_counter() - t0) * 1e3
            la = launched()
            require(la["k1"] == 1 and sum(la.values()) == 1,
                    f"io_coders remap {dither} launches {la}")
            k1_remap += la["k1"]
            replay = native.octree_remap(resized.to_numpy(), pal, key)
            want = tio.image_to_blob(TImage(replay, resized.spec,
                                            device="cpu"), "png")
            with open(target, "rb") as f:
                got = f.read()
            require(got == want, f"io_coders remap {dither}: the written "
                    f"PNG is not the remap replayed on the CPU")
            n_colors = len(np.unique(np.asarray(PImage.open(target))
                                     .reshape(-1, C), axis=0))
            print(f"io_coders cli: a MIFF frame -> -resize 50% -dither "
                  f"{dither} -remap pal.png ({len(REMAP_PALETTE)} colors) -> "
                  f"PNG: launches {la}, {wall:.4f} ms (first run); the PNG "
                  f"equal to the remap replayed on the CPU from the card's "
                  f"resize, {n_colors} colors [{name_limit}]")
    return {"k1": la1["k1"] + k1_remap, "k4": la4["k4"]}


def _dicom16(px: np.ndarray, intercept: int = -1024) -> bytes:
    """An explicit-VR little-endian DICOM of 16-bit MONOCHROME2 samples
    ``px`` with a rescale intercept, as a CT scanner writes one."""
    def elem(group, el, vr, value):
        if vr == b"OW":
            return (struct.pack("<HH2sHI", group, el, vr, 0, len(value))
                    + value)
        return struct.pack("<HH2sH", group, el, vr, len(value)) + value

    rows, cols = px.shape
    return (b"\0" * 128 + b"DICM"
            + elem(0x0028, 0x0002, b"US", struct.pack("<H", 1))
            + elem(0x0028, 0x0004, b"CS", b"MONOCHROME2 ")
            + elem(0x0028, 0x0010, b"US", struct.pack("<H", rows))
            + elem(0x0028, 0x0011, b"US", struct.pack("<H", cols))
            + elem(0x0028, 0x0100, b"US", struct.pack("<H", 16))
            + elem(0x0028, 0x0103, b"US", struct.pack("<H", 0))
            + elem(0x0028, 0x1052, b"DS", b"%d " % intercept)
            + elem(0x0028, 0x1053, b"DS", b"1 ")
            + elem(0x7FE0, 0x0010, b"OW", px.astype("<u2").tobytes()))


def _ct_slice(rng, n: int) -> np.ndarray:
    """An n x n CT slice in stored units (HU + 1024): air, a body
    ellipse of soft tissue, two bones, noise."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) / n - 0.5
    hu = np.full((n, n), -1000.0, np.float32)
    body = (xx / rng.uniform(0.38, 0.45)) ** 2 + \
        (yy / rng.uniform(0.3, 0.4)) ** 2 < 1
    hu[body] = rng.uniform(20, 60)
    for cx in (-0.2, 0.2):
        hu[(xx - cx) ** 2 + (yy - 0.05) ** 2 < 0.004] = rng.uniform(700,
                                                                   1200)
    hu += rng.normal(0, 12, hu.shape).astype(np.float32)
    return np.clip(hu + 1024, 0, 4095).astype(np.uint16)


def _cin10(q: np.ndarray) -> bytes:
    """A Kodak Cineon file of 10-bit codes ``q`` (h, w, c), filled three
    to a 32-bit word, as the JAX tests make one."""
    h, w, c = q.shape
    head = bytearray(2048)
    head[0:4] = b"\x80\x2a\x5f\xd7"
    struct.pack_into(">I", head, 4, 2048)
    head[193] = c
    for k in range(c):
        head[194 + 28 * k + 3] = 10
        struct.pack_into(">II", head, 194 + 28 * k + 4, w, h)
    flat = q.reshape(-1).astype(np.uint32)
    flat = np.concatenate([flat, np.zeros((-len(flat)) % 3, np.uint32)])
    t = flat.reshape(-1, 3)
    return bytes(head) + ((t[:, 0] << 22) | (t[:, 1] << 12) | (t[:, 2] << 2)
                          ).astype(">u4").tobytes()


def _xcf_tile_rle(chan: np.ndarray) -> bytes:
    """One tile channel in XCF's RLE: one long run where it is flat, else
    literal stretches of up to 127 bytes."""
    raw = chan.tobytes()
    if chan.min() == chan.max():
        return bytes([127]) + struct.pack(">H", len(raw)) + raw[:1]
    return b"".join(bytes([256 - len(raw[i:i + 127])]) + raw[i:i + 127]
                    for i in range(0, len(raw), 127))


def _xcf2(bottom: np.ndarray, top: np.ndarray, offset, opacity: int) -> bytes:
    """A GIMP XCF v1 of an RGB layer (``bottom``, the canvas's extent) and
    an RGBA layer ``top`` over it at ``offset`` (x, y) and ``opacity``
    (0-255), RLE tiles of 64 x 64."""
    h, w = bottom.shape[:2]
    buf = bytearray(b"gimp xcf v001\0" + struct.pack(">III", w, h, 0))
    buf += struct.pack(">II", 0, 0)
    table = len(buf)
    buf += bytes(12)
    props = [(struct.pack(">II", 6, 4) + struct.pack(">I", opacity) +
              struct.pack(">II", 15, 8) + struct.pack(">ii", *offset)),
             b""]
    for k, (px, ltype) in enumerate(((top, 1), (bottom, 0))):
        struct.pack_into(">I", buf, table + 4 * k, len(buf))
        lh, lw, bpp = px.shape
        buf += struct.pack(">III", lw, lh, ltype)
        buf += struct.pack(">I", 7) + b"layer%d\0" % k
        buf += props[k] + struct.pack(">II", 0, 0)
        buf += struct.pack(">II", len(buf) + 8, 0)        # hierarchy, mask
        buf += struct.pack(">III", lw, lh, bpp)
        buf += struct.pack(">II", len(buf) + 8, 0)        # level
        buf += struct.pack(">II", lw, lh)
        ntx, nty = -(-lw // 64), -(-lh // 64)
        tiles = len(buf)
        buf += bytes(4 * (ntx * nty + 1))
        for ty in range(nty):
            for tx in range(ntx):
                sub = px[ty * 64:(ty + 1) * 64, tx * 64:(tx + 1) * 64]
                struct.pack_into(">I", buf, tiles + 4 * (ty * ntx + tx),
                                 len(buf))
                for ch in range(bpp):
                    buf += _xcf_tile_rle(np.ascontiguousarray(sub[..., ch]))
    return bytes(buf)


def _fax_page(rng) -> np.ndarray:
    """A Letter page of FAX_H x FAX_W as a fax machine sends it: white,
    margins, lines of black word strokes (1.0 white, 0.0 black)."""
    page = np.ones((FAX_H, FAX_W), np.float32)
    for y in range(120, FAX_H - 160, 48):
        x = 100
        while x < FAX_W - 160:
            n = int(rng.integers(12, 90))
            page[y:y + int(rng.integers(18, 26)), x:x + n] = 0.0
            x += n + int(rng.integers(10, 30))
    return page


def io_formats_phase(dev, gen, name_limit: str, seed: int) -> dict:
    """io_formats: formats2's and formats3's coders at 1080p (each decode
    onto the card held to the CPU's bit for bit, each encode from the card
    to the CPU's bytes, ms an image) and ``cli.main.main`` from their
    files: 10-bit DPX frames through CLI_CODERS to DPX (one K1 launch),
    16-bit DICOM slices through -auto-threshold otsu to PBM (one K4
    launch) and G4 fax pages through CLI_PAGES to G4 (one K4 launch)."""
    import tempfile

    from PIL import Image as PImage

    from imagemagick_tpu_torch import io as tio
    from imagemagick_tpu_torch.core.image import Image as TImage
    from imagemagick_tpu_torch.core.spec import ImageSpec
    from imagemagick_tpu_torch.io import formats2 as f2
    from imagemagick_tpu_torch.io import formats3 as f3

    rng = np.random.default_rng(seed + 11)
    arr = _smooth_u8(rng, 1, IO_H, IO_W, C)[0]
    src = TImage(arr.astype(np.float32) / 255.0, device="cpu")
    gray = TImage(src.data.mean(-1, keepdim=True),
                  ImageSpec(colorspace="gray"), device="cpu")

    def blob_of(fmt):
        return lambda d: tio.image_from_blob(d[0], fmt, device=d[1])[0]

    # name: (encoder or None, decoder of (bytes, device) or None, image)
    coders = {
        "dpx 10-bit": (lambda im: f2.encode_dpx(im, 10), blob_of("dpx"), src),
        "dpx 16-bit": (lambda im: f2.encode_dpx(im, 16), blob_of("dpx"), src),
        "fits": (f2.encode_fits, blob_of("fits"), src),
        "avs": (f2.encode_avs, blob_of("avs"), src),
        "mtv": (f2.encode_mtv, blob_of("mtv"), src),
        "fl32": (f2.encode_fl32, blob_of("fl32"), src),
        "vicar": (f2.encode_vicar, blob_of("vicar"), src),
        "sun": (f2.encode_sun, blob_of("sun"), src),
        "mat": (lambda im: f3.encode_mat(im, 8), blob_of("mat"), src),
        "viff": (f3.encode_viff, blob_of("viff"), src),
        "rla": (f3.encode_rla, blob_of("rla"), src),
        "palm": (f3.encode_palm, blob_of("palm"), src),
        "pict": (f3.encode_pict, blob_of("pict"), src),
        "psd": (lambda im: f2.encode_psd(im, 8), None, src),
        "pdf": (f2.encode_pdf, None, src),
        "wbmp": (f2.encode_wbmp, blob_of("wbmp"), gray),
        "otb": (f2.encode_otb, blob_of("otb"), gray),
        "mono": (f2.encode_mono, lambda d: f2.decode_mono(
            d[0], IO_W, IO_H, device=d[1]), gray),
        "g3": (f2.encode_fax, lambda d: f2.decode_fax(
            d[0], IO_W, device=d[1]), gray),
        "g4": (f2.encode_g4_image, lambda d: f2.decode_g4_image(
            d[0], IO_W, device=d[1]), gray),
    }
    q10 = (arr.astype(np.int64) * 1023 + 127) // 255
    slice_px = _ct_slice(rng, IO_H)[:, :IO_H]
    top = np.concatenate([arr[:IO_H // 2, :IO_W // 2],
                          np.full((IO_H // 2, IO_W // 2, 1), 200, np.uint8)],
                         -1)
    top[IO_H // 8:IO_H // 4] = (40, 60, 200, 255)
    read_only = {"cin 10-bit": _cin10(q10),
                 "dcm 16-bit": _dicom16(np.tile(slice_px, (1, 2))[:, :IO_W]),
                 "xcf 2 layers": _xcf2(arr, top, (IO_W // 3, IO_H // 5), 180)}
    card_images = {"src": TImage(src.data.to(dev), src.spec),
                   "gray": TImage(gray.data.to(dev), gray.spec)}
    for name in list(coders) + list(read_only):
        encode, decode, image = coders.get(name, (None, None, None))
        if name in read_only:
            blob = read_only[name]
            decode = blob_of(name.split()[0])
        else:
            blob = encode(image)
        dec_ms = float("nan")
        if decode is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = decode((blob, dev))
            torch.cuda.synchronize()
            dec_ms = (time.perf_counter() - t0) * 1e3
            want = decode((blob, "cpu"))
            require(img.data.device == torch.device(dev) and
                    torch.equal(img.data.cpu(), want.data),
                    f"io_formats {name}: the card's decode is not the CPU's")
            shape = tuple(img.data.shape)
        enc_ms = float("nan")
        if encode is not None:
            on_card = card_images["gray" if image is gray else "src"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = encode(on_card)
            enc_ms = (time.perf_counter() - t0) * 1e3
            require(got == blob, f"io_formats {name}: the card's encode is "
                    f"not the CPU's")
            shape = tuple(image.data.shape)
        held = ", ".join(
            what for what, has in (("the decode equal to the CPU's", decode),
                                   ("the encode's bytes the CPU's", encode))
            if has is not None)
        print(f"io_formats {name} {'x'.join(map(str, shape))} ({len(blob)} "
              f"bytes): decode to the card {dec_ms:.4f} ms, encode from it "
              f"{enc_ms:.4f} ms (one run each, host clock; nan: not a "
              f"reader or not a writer); {held} [{name_limit}]")

    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "out")
        # (a) film frames: 10-bit DPX through CLI_CODERS, one K1 launch
        frames = []
        for k, a in enumerate(_smooth_u8(rng, FORMAT_FRAMES, IO_H, IO_W, C)):
            frames.append(os.path.join(td, f"frame{k}.dpx"))
            with open(frames[-1], "wb") as f:
                f.write(tio.image_to_blob(TImage(
                    a.astype(np.float32) / 255.0, device="cpu"), "dpx",
                    depth=16))
        reset_launches()
        t0 = time.perf_counter()
        _main_ok(frames + CLI_CODERS + [out + "-%d.dpx"], dev)
        wall = (time.perf_counter() - t0) * 1e3
        la1 = launched()
        require(la1["k1"] == 1 and sum(la1.values()) == 1,
                f"io_formats DPX chain launches {la1}")
        _main_ok(frames + CLI_CODERS + [out + "-cpu-%d.dpx"], "cpu")
        codes, moved = 0, 0.0
        for k in range(FORMAT_FRAMES):
            a, b = (np.rint(tio.read_images(f"{out}{side}-{k}.dpx",
                                            device="cpu")[0].data.numpy()
                            * 1023).astype(np.int64)
                    for side in ("", "-cpu"))
            require(a.shape == b.shape == (IO_H // 2, IO_W // 2, 1),
                    f"io_formats DPX output {k} {a.shape}")
            codes = max(codes, int(np.abs(a - b).max()))
            moved = max(moved, float(np.mean(a != b)))
        require(codes <= DPX_CODES, f"io_formats DPX chain: {codes} codes")
        print(f"io_formats cli: {FORMAT_FRAMES} 10-bit DPX frames of {IO_H}x"
              f"{IO_W}x{C} -> {' '.join(CLI_CODERS)} -> out-%d.dpx by "
              f"main(..., device='cuda'): launches {la1}, {wall:.4f} ms "
              f"({wall / FORMAT_FRAMES:.4f} ms a frame, first run); at most "
              f"{codes} 10-bit code from the CPU run (bound {DPX_CODES}), "
              f"{moved:.2e} of the samples moved [{name_limit}]")

        # (b) CT slices: 16-bit DICOM through -auto-threshold otsu, one K4
        slices, values = [], []
        for k in range(CT_SLICES):
            slices.append(os.path.join(td, f"slice{k}.dcm"))
            with open(slices[-1], "wb") as f:
                f.write(_dicom16(_ct_slice(rng, CT_SIZE)))
            values.append(tio.read_images(slices[-1], device="cpu")[0]
                          .data.numpy()[..., 0])
        argv = ["-auto-threshold", "otsu"]
        reset_launches()
        t0 = time.perf_counter()
        _main_ok(slices + argv + [out + "-ct-%d.pbm"], dev)
        wall = (time.perf_counter() - t0) * 1e3
        la4 = launched()
        require(la4["k4"] == 1 and sum(la4.values()) == 1,
                f"io_formats DICOM slices launches {la4}")
        _main_ok(slices + argv + [out + "-cpu-ct-%d.pbm"], "cpu")
        bins = []
        for k in range(CT_SLICES):
            a = np.asarray(PImage.open(f"{out}-ct-{k}.pbm"))
            b = np.asarray(PImage.open(f"{out}-cpu-ct-{k}.pbm"))
            require(a.shape == b.shape == (CT_SIZE, CT_SIZE) and
                    np.array_equal(a, b), f"io_formats slice {k}: the "
                    f"card's page is not the CPU run's")
            j = otsu_bin_f64(values[k])
            t = np.float32(j) * np.float32(1.0 / 255)
            require(np.array_equal(a, values[k] > t), f"io_formats slice "
                    f"{k}: not thresholded at the float64 Otsu bin {j}")
            bins.append(j)
        print(f"io_formats cli: {CT_SLICES} 16-bit DICOM slices of "
              f"{CT_SIZE}x{CT_SIZE} -> -auto-threshold otsu -> ct-%d.pbm: "
              f"launches {la4}, {wall:.4f} ms (first run); pages equal to "
              f"the CPU run's and thresholded at the float64 Otsu bins "
              f"{bins} [{name_limit}]")

        # (c) fax pages: G4 through CLI_PAGES to G4, one K4 launch
        pages = []
        for k in range(FAX_PAGES):
            pages.append(os.path.join(td, f"page{k}.g4"))
            page = TImage(_fax_page(rng)[..., None],
                          ImageSpec(colorspace="gray", depth=1),
                          device="cpu")
            with open(pages[-1], "wb") as f:
                f.write(tio.image_to_blob(page, "g4"))
        reset_launches()
        t0 = time.perf_counter()
        _main_ok(pages + CLI_PAGES + [out + "-fax-%d.g4"], dev)
        wall = (time.perf_counter() - t0) * 1e3
        la4f = launched()
        require(la4f["k4"] == 1 and la4f["k1"] == 0,
                f"io_formats fax pages launches {la4f}")
        _main_ok(pages + CLI_PAGES + [out + "-cpu-fax-%d.g4"], "cpu")
        for k in range(FAX_PAGES):
            with open(f"{out}-fax-{k}.g4", "rb") as f:
                a = f.read()
            with open(f"{out}-cpu-fax-{k}.g4", "rb") as f:
                b = f.read()
            require(a == b, f"io_formats fax page {k}: the card's G4 bytes "
                    f"are not the CPU run's")
            rows = f2.decode_g4_image(a, FAX_W, device="cpu").data.shape[0]
            require(rows == FAX_H, f"io_formats fax page {k}: {rows} rows")
        print(f"io_formats cli: {FAX_PAGES} G4 pages of {FAX_H}x{FAX_W} -> "
              f"{' '.join(CLI_PAGES)} -> fax-%d.g4: launches {la4f}, "
              f"{wall:.4f} ms (first run); the G4 bytes the CPU run's "
              f"[{name_limit}]")
    return {"k1": la1["k1"], "k4": la4["k4"] + la4f["k4"]}


def _sct_ct(arr: np.ndarray) -> bytes:
    """A Scitex CT file of ``arr`` (H, W, 3 u8): the 2048-byte parameter
    block, then each row's separations, padded to an even width."""
    h, w, c = arr.shape
    head = bytearray(2048)
    head[0:8] = b"scan.sct"
    head[80:82] = b"CT"
    head[1025] = c
    head[1026:1028] = (0x07).to_bytes(2, "big")
    head[1056:1068] = str(h).ljust(12).encode()
    head[1068:1080] = str(w).ljust(12).encode()
    rows = np.zeros((h, c, w + (w & 1)), np.uint8)
    rows[:, :, :w] = arr.transpose(0, 2, 1)
    return bytes(head) + rows.tobytes()


def _sfw_of(jpeg: bytes) -> bytes:
    """A Seattle FilmWorks SFW of a JPEG: its Huffman tables dropped, its
    markers scrambled as sfw.c's reader expects, the JFIF id blanked."""
    from imagemagick_tpu_torch.io import formats4 as f4

    inv = {v: k for k, v in f4._SFW_XLAT.items()}
    out, i = bytearray(), 0
    while i < len(jpeg):
        if jpeg[i] == 0xFF and i + 3 < len(jpeg):
            m, n = jpeg[i + 1], (jpeg[i + 2] << 8) | jpeg[i + 3]
            if m == 0xC4:
                i += 2 + n
                continue
            if m == 0xE0:
                seg = bytearray(jpeg[i:i + 2 + n])
                seg[1], seg[4:11] = 0xD0, b"\0" * 7
                out += seg
                i += 2 + n
                continue
            if m in inv:
                out += bytes([0xFF, inv[m]])
                i += 2
                continue
        out.append(jpeg[i])
        i += 1
    out[-2:] = b"\xff\xc9"
    return b"SFW94A" + bytes(out)


def _legacy_files(rng, jpeg: bytes, tile: np.ndarray) -> dict:
    """Hand-built files of the read-only formats4 coders at their own
    formats' sizes: a ZX Spectrum screen, Scitex CT, SFW and PWP, Dr Halo
    CUT, Utah RLE, a MacPaint page, Alias PIX, TIM2, a Garmin JNX tile and
    a Brother PES design."""
    h, w = tile.shape[:2]
    cut = b"".join(struct.pack("<H", 7) + bytes(
        [0x80 | 100, int(v), 0x03, 10, 20, 30, 0])
        for v in rng.integers(0, 256, 40))
    rle = b"\x52\xcc" + struct.pack("<4H", 0, 0, w, h) + \
        bytes([0x02, 3, 8, 0, 0, 0])
    body = bytearray()
    for y in range(h):
        for p in range(3):
            body += bytes([0x02, p, 0x45, 0]) + struct.pack("<h", w - 1)
            body += tile[h - 1 - y, :, p].tobytes() + b"\0" * (w & 1)
        body += bytes([0x01, 1])
    rle += bytes(body) + bytes([0x07, 0])
    mac = bytearray()
    for _ in range(72 * 720 // 64):
        mac += bytes([(~(64 - 2)) & 0xFF, int(rng.integers(0, 256))])
    pix = struct.pack(">5H", w, h, 0, 0, 24) + b"".join(
        bytes([w]) + tile[y, 0, ::-1].tobytes() for y in range(h))
    tim2 = tile[..., 0].astype(np.uint16) >> 3
    words = (tim2 | ((tile[..., 1].astype(np.uint16) >> 3) << 5)
             | ((tile[..., 2].astype(np.uint16) >> 3) << 10) | 0x8000)
    ihdr = struct.pack("<3IHH", 48 + 2 * w * h, 0, 2 * w * h, 48, 0)
    ihdr += bytes([0, 1, 0, 1]) + struct.pack("<HH", w, h) + b"\0" * 24
    jnx_tile = jpeg[2:]
    head = struct.pack("<12i", 3, 0, 100, 100, -100, -100, 1, 0, 0, 0, 0, 0)
    level = struct.pack("<iii", 1, len(head) + 12, 0)
    entry = struct.pack("<4iHHIi", 50, 60, -50, -60, w, h, len(jnx_tile),
                        len(head) + 40)
    pes = bytearray(b"#PES0001" + struct.pack("<i", 0) + b"\0" * 36)
    pes += bytes([1, 5, 20]) + b"\0" * (532 - 2 - 21)
    for k in range(400):
        dx, dy = rng.integers(-40, 41, 2)
        pes += bytes([int(dx) & 0x7F, int(dy) & 0x7F])
        if k == 200:
            pes += bytes([254, 176, 0])
    pes += b"\xff\x00"
    return {"scr": rng.integers(0, 256, 6912).astype(np.uint8).tobytes(),
            "sct": _sct_ct(tile), "sfw": _sfw_of(jpeg),
            "pwp": b"SFW95" + b"\0" * 8 + _sfw_of(jpeg) * 2,
            "cut": struct.pack("<HHH", 103, 40, 0) + cut,
            "rle": rle,
            "mac": struct.pack("<H", 0) + b"\0" * 510 + bytes(mac),
            "pix": pix,
            "tim2": b"TIM2\x04\0\1\0" + b"\0" * 8 + ihdr +
            words.astype("<u2").tobytes(),
            "jnx": head + level + entry + jnx_tile, "pes": bytes(pes)}


def _font_file():
    """A TrueType font's bytes: the first at the draw module's paths, else
    the Aileron Regular that Pillow (10.1 on, with FreeType) embeds for
    its default font; None where there is neither."""
    from PIL import ImageFont

    from imagemagick_tpu_torch.ops import draw as tdraw

    for path in tdraw._FONT_PATHS:
        if os.path.exists(path):
            with open(path, "rb") as f:
                return f.read()
    got = []
    real = ImageFont.truetype

    def grab(font, *args, **kw):
        if isinstance(font, io.BytesIO):
            got.append(font.getvalue())
        return real(font, *args, **kw)

    ImageFont.truetype = grab
    try:
        ImageFont.load_default(12)
    except (OSError, TypeError, ImportError):
        return None
    finally:
        ImageFont.truetype = real
    return got[0] if got else None


def _cube_lut(rng, n: int) -> bytes:
    """A .cube LUT of n points a side from ``rng``: a smooth curve a
    channel (a gamma and a lift) with a little cross-talk, red fastest."""
    g = np.linspace(0.0, 1.0, n)
    gam = rng.uniform(0.8, 1.25, 3)
    lift = rng.uniform(0.0, 0.05, 3)
    b, gg, r = np.meshgrid(g, g, g, indexing="ij")
    rgb = np.stack([r, gg, b], -1)
    out = lift + (1 - lift) * rgb ** gam
    out = out + 0.03 * (rgb[..., [1, 2, 0]] - rgb)
    rows = "\n".join("%.6f %.6f %.6f" % tuple(v)
                     for v in np.clip(out, 0, 1).reshape(-1, 3))
    return (f'TITLE "seeded grade"\nLUT_3D_SIZE {n}\n{rows}\n').encode()


def io_formats4_phase(dev, gen, name_limit: str, seed: int) -> dict:
    """io_formats4: formats4's coders (the 1080p frame through its raster
    and video coders, each decode onto the card held to the CPU's bit for
    bit and each encode from the card to the CPU's bytes; HRZ, YUV, UYVY,
    MAP, WPG and MVG with their device ops on the card; the small, legacy
    and text formats at their own sizes; a stegano: read) and
    ``cli.main.main`` from its files: 48-bit TIFF frames through
    CLI_CODERS to 16-bit TIFFs (one K1 launch), a 48-bit frame graded by
    a .cube LUT through -hald-clut, and CALS pages through CLI_PAGES (one
    K4 launch)."""
    import tempfile

    from imagemagick_tpu_torch import io as tio
    from imagemagick_tpu_torch.core.image import Image as TImage
    from imagemagick_tpu_torch.core.policy import no_host_files
    from imagemagick_tpu_torch.core.spec import ImageSpec
    from imagemagick_tpu_torch.io import formats4 as f4
    from imagemagick_tpu_torch.ops import threshold as tth
    from imagemagick_tpu_torch.ops import visual_effects as tvfx

    rng = np.random.default_rng(seed + 12)
    arr = _smooth_u8(rng, 1, IO_H, IO_W, C)[0]
    src = TImage(arr.astype(np.float32) / 255.0,
                 ImageSpec(colorspace="srgb", depth=16), device="cpu")
    gray = TImage(src.data.mean(-1, keepdim=True),
                  ImageSpec(colorspace="gray", depth=16), device="cpu")
    bilevel = TImage((gray.data > 0.5).to(torch.float32),
                     ImageSpec(colorspace="gray", depth=1), device="cpu")
    on_card = {id(im): TImage(im.data.to(dev), im.spec)
               for im in (src, gray, bilevel)}

    def blob_of(fmt):
        return lambda b, d: tio.image_from_blob(b, fmt, device=d)[0]

    def sized(decode):
        return lambda b, d: decode(b, IO_W, IO_H, device=d)

    def ept_tiff(b, d):
        # the ghostscript delegate refused, as for a served request: the
        # EPT's TIFF section is read
        with no_host_files():
            return tio.image_from_blob(b, "ept", device=d)[0]

    # name: (encoder, decoder of (bytes, device), image, bytes held within
    # this many levels of the CPU's (None: equal))
    coders = {
        "aai": (f4.encode_aai, blob_of("aai"), src, None),
        "pgx 8-bit": (lambda im: f4.encode_pgx(im, 8), blob_of("pgx"), src,
                      None),
        "pgx 16-bit": (lambda im: f4.encode_pgx(im, 16), blob_of("pgx"),
                       src, None),
        "vips 8-bit": (lambda im: f4.encode_vips(im, 8), blob_of("vips"),
                       src, None),
        "vips 16-bit": (lambda im: f4.encode_vips(im, 16), blob_of("vips"),
                        src, None),
        "xwd": (f4.encode_xwd, blob_of("xwd"), src, None),
        "tim": (f4.encode_tim, blob_of("tim"), src, None),
        "pdb": (f4.encode_pdb, blob_of("pdb"), src, None),
        "ipl 16-bit": (lambda im: f4.encode_ipl(im, 16), blob_of("ipl"),
                       src, None),
        "ept": (f4.encode_ept, ept_tiff, src, None),
        "tiff 16-bit rgb": (lambda im: tio.image_to_blob(im, "tiff"),
                            blob_of("tiff"), src, None),
        "tiff 16-bit gray": (lambda im: tio.image_to_blob(im, "tiff"),
                             blob_of("tiff"), gray, None),
        "yuv": (f4.encode_yuv, sized(f4.decode_yuv), src, YCC_LEVELS),
        "bayer 8-bit": (lambda im: f4.encode_bayer(im, 8),
                        sized(f4.decode_bayer), src, None),
        "bayer 16-bit": (lambda im: f4.encode_bayer(im, 16),
                         sized(f4.decode_bayer), src, None),
        "cals": (f4.encode_cals, blob_of("cals"), bilevel, None),
        "art": (f4.encode_art, blob_of("art"), bilevel, None),
        "uyvy": (lambda im: tio.image_to_blob(im, "uyvy"),
                 sized(f4.decode_uyvy), src, YCC_LEVELS),
    }
    for name, (encode, decode, image, levels) in coders.items():
        blob = encode(image)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = decode(blob, dev)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3
        want = decode(blob, "cpu")
        require(img.data.device == torch.device(dev) and
                torch.equal(img.data.cpu(), want.data),
                f"io_formats4 {name}: the card's decode is not the CPU's")
        t0 = time.perf_counter()
        got = encode(on_card[id(image)])
        enc_ms = (time.perf_counter() - t0) * 1e3
        if levels is None:
            require(got == blob, f"io_formats4 {name}: the card's encode "
                    f"is not the CPU's")
            held = "the encode's bytes the CPU's"
        else:
            a, b = (np.frombuffer(x, np.uint8) for x in (got, blob))
            apart = int(np.abs(a.astype(np.int64) - b).max())
            require(a.shape == b.shape and apart <= levels,
                    f"io_formats4 {name}: {apart} levels from the CPU's")
            held = (f"the encode's bytes within {apart} level of the "
                    f"CPU's (bound {levels}), {_share_apart(a, b, 0):.2e} "
                    f"of them moved")
        print(f"io_formats4 {name} {'x'.join(map(str, image.data.shape))} "
              f"({len(blob)} bytes): decode to the card {dec_ms:.4f} ms, "
              f"encode from it {enc_ms:.4f} ms (one run each, host clock); "
              f"the decode equal to the CPU's, {held} [{name_limit}]")

    # the device-side writers: HRZ's resize, MAP's and WPG's k-means, MVG
    card_src = on_card[id(src)]
    t0 = time.perf_counter()
    hrz = f4.encode_hrz(card_src)
    hrz_ms = (time.perf_counter() - t0) * 1e3
    a, b = (np.frombuffer(x, np.uint8).astype(np.int64)
            for x in (hrz, f4.encode_hrz(src)))
    apart = int(np.abs(a - b).max())
    require(len(a) == 256 * 240 * 3 and apart <= HRZ_CODES,
            f"io_formats4 hrz: {apart} codes from the CPU's")
    print(f"io_formats4 hrz from {IO_H}x{IO_W}x{C}: the resize to 256x240 on "
          f"the card, {hrz_ms:.4f} ms; within {apart} 6-bit code of the "
          f"CPU's bytes (bound {HRZ_CODES}), {_share_apart(a, b, 0):.2e} of "
          f"them moved [{name_limit}]")
    palettes = {}
    for fmt, encode in (("map", f4.encode_map), ("wpg", f4.encode_wpg)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = encode(card_src)
        ms = (time.perf_counter() - t0) * 1e3
        if fmt == "map":
            pal = np.frombuffer(blob, np.uint8, 768).reshape(256, 3)
            labels = np.frombuffer(blob, np.uint8, IO_H * IO_W, 768)
            decoded = f4.decode_map(blob, IO_W, IO_H, device=dev)
            want = pal[labels].reshape(IO_H, IO_W, 3)
            palettes["map"] = decoded.data
        else:
            decoded = f4.decode_wpg(blob, device=dev)
            want = None
        require(decoded.data.is_cuda, f"io_formats4 {fmt}: not on the card")
        if want is not None:
            require(torch.equal(decoded.data.cpu(), torch.from_numpy(
                want.astype(np.float32) / 255.0)),
                f"io_formats4 map: not the palette indexed by the labels")
        else:
            require(torch.equal(decoded.data, palettes["map"]),
                    "io_formats4 wpg: not the MAP file's palette and labels")
        crop = TImage(src.data[:SMALL4[0], :SMALL4[1]], src.spec,
                      device="cpu")
        card_crop = TImage(crop.data.to(dev), crop.spec)
        require(encode(card_crop) == encode(crop),
                f"io_formats4 {fmt}: the card's bytes at {SMALL4} are not "
                f"the CPU's")
        held = ("decodes to its palette indexed by its labels "
                f"({len(np.unique(labels))} used)" if fmt == "map" else
                "decodes to the MAP file's image")
        print(f"io_formats4 {fmt} {IO_H}x{IO_W}x{C} ({len(blob)} bytes): "
              f"k-means of 256 colours on the card, encode {ms:.4f} ms (one "
              f"run, host clock); the file {held}; the bytes of a "
              f"{SMALL4[0]}x{SMALL4[1]} crop the CPU's [{name_limit}]")
    t0 = time.perf_counter()
    mvg = f4.decode_mvg(MVG4.encode(), device=dev)
    torch.cuda.synchronize()
    mvg_ms = (time.perf_counter() - t0) * 1e3
    want = f4.decode_mvg(MVG4.encode(), device="cpu")
    err, n_off, n_px = _apart(mvg.data.cpu()[None], want.data[None],
                              DRAW_TOL)
    require(mvg.data.is_cuda and tuple(mvg.data.shape) == (IO_H, IO_W, C)
            and err <= DRAW_TOL, f"io_formats4 mvg max|d| {err}")
    print(f"io_formats4 mvg ({MVG4.count(chr(10))} lines) on a {IO_H}x{IO_W} "
          f"canvas on the card: {mvg_ms:.4f} ms; max|d| {err:.3e} from the "
          f"CPU's, {n_off} of {n_px} px apart by more than {DRAW_TOL} "
          f"[{name_limit}]")

    # the small, fixed-size and text formats at their own sizes
    from PIL import Image as PImage

    tile = arr[:40, :103]
    buf = io.BytesIO()
    PImage.fromarray(arr[:96, :128]).save(buf, "JPEG", quality=90)
    small = TImage(src.data[:SMALL4[0], :SMALL4[1]],
                   ImageSpec(colorspace="srgb", depth=8), device="cpu")
    icon = TImage(src.data[:48, :64], ImageSpec(colorspace="srgb", depth=8),
                  device="cpu")
    rgba = TImage(torch.cat([icon.data, gray.data[:48, :64]], -1),
                  ImageSpec(colorspace="srgb", alpha=True, depth=8),
                  device="cpu")
    files = _legacy_files(rng, buf.getvalue(), tile)
    files["cube"] = _cube_lut(rng, CUBE_N)
    ttf = _font_file()
    if ttf is None:
        print("io_formats4 ttf: skipped: no TrueType font at the draw "
              "module's paths, and this Pillow embeds none (it has no "
              "FreeType or predates 10.1)")
    else:
        files["ttf"] = ttf
    # writers with a reader: their bytes decoded too
    writers = {"rgf": (f4.encode_rgf, icon), "inline": (f4.encode_inline,
                                                        icon),
               "txt": (lambda im: tio.image_to_blob(im, "txt"), small),
               "ftxt": (f4.encode_ftxt, small),
               "magick": (f4.encode_magick, small),
               "cip": (f4.encode_cip, icon), "uil": (f4.encode_uil, icon),
               "html": (f4.encode_html, icon), "cur": (f4.encode_cur, rgba),
               "ashlar": (lambda im: f4.encode_ashlar([im, icon, im]), icon),
               "dcx": (lambda im: f4.encode_dcx([im, icon]), icon)}
    for variant in ("brf", "ubrl", "ubrl6", "isobrl", "isobrl6"):
        writers[variant] = (lambda im, v=variant: f4.encode_braille(im, v),
                            icon)
    readers = {"rgf", "inline", "txt", "ftxt", "magick"}
    for name, (encode, image) in writers.items():
        blob = encode(image)
        t0 = time.perf_counter()
        got = encode(TImage(image.data.to(dev), image.spec))
        enc_ms = (time.perf_counter() - t0) * 1e3
        require(got == blob, f"io_formats4 {name}: the card's encode is not "
                f"the CPU's")
        if name in readers:
            files[name] = blob
        else:
            print(f"io_formats4 {name} {'x'.join(map(str, image.data.shape))}"
                  f" ({len(blob)} bytes): encode from the card {enc_ms:.4f} "
                  f"ms (one run, host clock); the CPU's bytes [{name_limit}]")
    for name, blob in files.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs = tio.image_from_blob(blob, name, device=dev)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3
        want = tio.image_from_blob(blob, name, device="cpu")
        require(len(imgs) == len(want) and all(
            g.data.is_cuda and torch.equal(g.data.cpu(), w.data)
            for g, w in zip(imgs, want)),
            f"io_formats4 {name}: the card's decode is not the CPU's")
        print(f"io_formats4 {name} ({len(blob)} bytes): decode to the card "
              f"{dec_ms:.4f} ms, {len(imgs)} image(s) of "
              f"{'x'.join(map(str, imgs[0].data.shape))} (one run, host "
              f"clock); equal to the CPU's decode [{name_limit}]")

    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "out")
        # stegano: a watermark hidden on the card, read back from a PNG
        wm = (torch.from_numpy(rng.random((60, 80, 1)) > 0.5)
              .to(torch.float32))
        host = tvfx.stegano(on_card[id(src)].data[:SMALL4[0], :SMALL4[1]],
                            wm.to(dev))
        png = os.path.join(td, "stamped.png")
        tio.write_image(TImage(host, ImageSpec(colorspace="srgb")), png)
        got = tio.read_images("stegano:" + png, "80x60", device=dev)[0]
        want = tio.read_images("stegano:" + png, "80x60", device="cpu")[0]
        require(got.data.is_cuda and torch.equal(got.data.cpu(), want.data)
                and torch.equal(want.data, wm),
                "io_formats4 stegano: the watermark did not come back")
        print(f"io_formats4 stegano: an 80x60 watermark hidden by "
              f"vfx.stegano on the card in a {SMALL4[0]}x{SMALL4[1]} PNG, "
              f"read back by stegano: onto the card, equal to it and to the "
              f"CPU's read [{name_limit}]")

        # (a) deep masters: 48-bit TIFFs through CLI_CODERS, one K1 launch
        frames = []
        for k, a in enumerate(_smooth_u8(rng, DEEP_FRAMES, IO_H, IO_W, C)):
            frames.append(os.path.join(td, f"frame{k}.tif"))
            with open(frames[-1], "wb") as f:
                f.write(tio.image_to_blob(TImage(
                    a.astype(np.float32) / 255.0, device="cpu"), "tiff",
                    depth=16))
        argv = CLI_CODERS + ["-depth", "16"]
        reset_launches()
        t0 = time.perf_counter()
        _main_ok(frames + argv + [out + "-%d.tif"], dev)
        wall = (time.perf_counter() - t0) * 1e3
        la1 = launched()
        require(la1["k1"] == 1 and sum(la1.values()) == 1,
                f"io_formats4 deep chain launches {la1}")
        _main_ok(frames + argv + [out + "-cpu-%d.tif"], "cpu")
        codes, moved = 0, 0.0
        for k in range(DEEP_FRAMES):
            a, b = (f4.decode_tiff16(open(f"{out}{side}-{k}.tif",
                                          "rb").read(), device="cpu")
                    for side in ("", "-cpu"))
            require(a.spec.depth == 16 and tuple(a.data.shape) ==
                    (IO_H // 2, IO_W // 2, 1) and a.data.shape ==
                    b.data.shape, f"io_formats4 deep output {k}: "
                    f"{tuple(a.data.shape)} at depth {a.spec.depth}")
            qa, qb = (np.rint(x.data.numpy() * 65535).astype(np.int64)
                      for x in (a, b))
            codes = max(codes, int(np.abs(qa - qb).max()))
            moved = max(moved, float(np.mean(qa != qb)))
        require(codes <= TIFF16_CODES, f"io_formats4 deep chain: {codes} "
                f"codes")
        print(f"io_formats4 cli: {DEEP_FRAMES} 48-bit TIFF frames of {IO_H}x"
              f"{IO_W}x{C} -> {' '.join(argv)} -> out-%d.tif (16-bit gray) "
              f"by main(..., device='cuda'): launches {la1}, {wall:.4f} ms "
              f"({wall / DEEP_FRAMES:.4f} ms a frame, first run); at most "
              f"{codes} 16-bit codes from the CPU run (bound {TIFF16_CODES}),"
              f" {moved:.2e} of the samples moved [{name_limit}]")

        # (b) a grade: a 48-bit frame through -hald-clut with a .cube LUT
        lut = os.path.join(td, "look.cube")
        with open(lut, "wb") as f:
            f.write(files["cube"])
        argv = [frames[0], lut, "-hald-clut", "-depth", "16"]
        reset_launches()
        t0 = time.perf_counter()
        _main_ok(argv + [out + "-graded.tif"], dev)
        wall = (time.perf_counter() - t0) * 1e3
        lag = launched()
        _main_ok(argv + [out + "-cpu-graded.tif"], "cpu")
        a, b = (f4.decode_tiff16(open(f"{out}{side}-graded.tif", "rb").read(),
                                 device="cpu") for side in ("", "-cpu"))
        require(tuple(a.data.shape) == (IO_H, IO_W, C) and a.spec.depth == 16,
                f"io_formats4 grade: {tuple(a.data.shape)}")
        qa, qb = (np.rint(x.data.numpy() * 65535).astype(np.int64)
                  for x in (a, b))
        codes = int(np.abs(qa - qb).max())
        require(codes <= GRADE_CODES, f"io_formats4 grade: {codes} codes")
        print(f"io_formats4 cli: a 48-bit TIFF frame of {IO_H}x{IO_W}x{C} "
              f"and a {CUBE_N}-point .cube LUT -> -hald-clut -depth 16 -> "
              f"out.tif: launches {lag}, {wall:.4f} ms (first run); at most "
              f"{codes} 16-bit code from the CPU run (bound {GRADE_CODES}), "
              f"{float(np.mean(qa != qb)):.2e} of the samples moved "
              f"[{name_limit}]")

        # (c) drawings: CALS pages through CLI_PAGES, one K4 launch
        pages, values = [], []
        for k in range(CALS_PAGES):
            pages.append(os.path.join(td, f"page{k}.cals"))
            page = TImage(_fax_page(rng)[..., None],
                          ImageSpec(colorspace="gray", depth=1),
                          device="cpu")
            with open(pages[-1], "wb") as f:
                f.write(tio.image_to_blob(page, "cals"))
            values.append(tio.read_images(pages[-1], device="cpu")[0].data)
        reset_launches()
        t0 = time.perf_counter()
        _main_ok(pages + CLI_PAGES + [out + "-page-%d.cals"], dev)
        wall = (time.perf_counter() - t0) * 1e3
        la4 = launched()
        require(la4["k4"] == 1 and la4["k1"] == 0,
                f"io_formats4 CALS pages launches {la4}")
        _main_ok(pages + CLI_PAGES + [out + "-cpu-page-%d.cals"], "cpu")
        for k in range(CALS_PAGES):
            with open(f"{out}-page-{k}.cals", "rb") as f:
                a = f.read()
            with open(f"{out}-cpu-page-{k}.cals", "rb") as f:
                b = f.read()
            require(a == b, f"io_formats4 CALS page {k}: the card's bytes "
                    f"are not the CPU run's")
            rows = f4.decode_cals(a, device="cpu").data.shape
            require(tuple(rows) == (FAX_H, FAX_W, 1),
                    f"io_formats4 CALS page {k}: {tuple(rows)}")
        # each page's Otsu value on the card (outside the counted run)
        t = tth.auto_threshold_values(torch.stack(values).to(dev), "otsu")
        bins = [otsu_bin_f64(v.numpy()[..., 0]) for v in values]
        require(torch.equal(t.cpu(), torch.tensor(
            [np.float32(j) * np.float32(1.0 / 255) for j in bins])),
            f"io_formats4 CALS pages: Otsu {t.tolist()} not the float64 "
            f"bins {bins}")
        print(f"io_formats4 cli: {CALS_PAGES} CALS pages of {FAX_H}x{FAX_W} "
              f"-> {' '.join(CLI_PAGES)} -> page-%d.cals: launches {la4}, "
              f"{wall:.4f} ms (first run); the CALS bytes the CPU run's; "
              f"Otsu on the card at the float64 bins {bins} [{name_limit}]")
    return {"k1": la1["k1"] + lag["k1"], "k4": la4["k4"] + lag["k4"]}


# -- io_stream: the out-of-core tier and the last coders ----------------------

def _scan_ppm(path: str, seed: int) -> None:
    """An 8-bit P6 of SCAN_H x SCAN_W x 3 from ``seed``, written a band at
    a time: a smooth shading across the page (periods of hundreds of
    pixels), darker text-like blocks and noise of a few levels, as a
    scanned print looks."""
    rng = np.random.default_rng(seed + 24)
    fy, fx = rng.uniform(300.0, 900.0, 2)
    ph = rng.uniform(0.0, 6.3, C).astype(np.float32)
    shade_x = (0.35 * 255.0 * np.cos(
        np.arange(SCAN_W, dtype=np.float32)[:, None] / np.float32(fx)
        + ph)).astype(np.float32)                          # (W, C)
    blocks = rng.integers(0, (SCAN_H, SCAN_W), (64, 2))
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (SCAN_W, SCAN_H))
        for y0 in range(0, SCAN_H, STREAM_BAND):
            n = min(STREAM_BAND, SCAN_H - y0)
            shade_y = np.sin(np.arange(y0, y0 + n, dtype=np.float32) /
                             np.float32(fy))[:, None, None]
            band = np.float32(127.5) + shade_y * shade_x
            for by, bx in blocks:
                if y0 <= by < y0 + n:
                    band[by - y0:by - y0 + 40, bx:bx + 300] *= 0.4
            band += rng.integers(-6, 7, band.shape, dtype=np.int8)
            np.clip(band, 0, 255, out=band)
            f.write(band.astype(np.uint8).tobytes())


def _ppm_body(path: str) -> np.ndarray:
    """The u8 samples of a P6 written by _scan_ppm or the streaming
    writer (a three-line header), as a writable array."""
    data = np.fromfile(path, np.uint8)
    head = data[:64].tobytes()
    pos = 0
    for _ in range(3):
        pos = head.index(b"\n", pos) + 1
    return data[pos:]


def _stream_run(fn) -> dict:
    """Run ``fn`` with the launch counts set to 0 just before and read
    just after, under tracemalloc (numpy's buffers included) and with
    the card's peak allocation reset: its seconds and both peaks."""
    import tracemalloc

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    tracemalloc.start()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    host_peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    return {"s": secs, "host": host_peak,
            "card": torch.cuda.max_memory_allocated() - base,
            "launches": launched()}


def _wmf_rec(func: int, params, tail: bytes = b"") -> bytes:
    body = b"".join(struct.pack("<h", p) if -32768 <= p < 32768
                    else struct.pack("<H", p & 0xFFFF) for p in params)
    body += tail + b"\0" * (len(tail) & 1)
    return struct.pack("<IH", 3 + len(body) // 2, func) + body


def _dib24(arr: np.ndarray) -> bytes:
    """A BITMAPINFOHEADER and the 24-bit bottom-up rows of (h, w, 3) u8."""
    h, w, _ = arr.shape
    stride = (w * 3 + 3) & ~3
    rows = b"".join(arr[y, :, ::-1].tobytes().ljust(stride, b"\0")
                    for y in range(h - 1, -1, -1))
    return struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(rows), 0, 0,
                       0, 0) + rows


def _wmf_1080(rng, dib: bool = True) -> tuple:
    """A placeable WMF that decodes to 1920x1080 at 72 dpi, and its record
    count: a null and a solid pen, two brushes and a font; a rectangle, a
    polygon, a polypolygon, an ellipse and a round rect filled; a
    polyline and two lines stroked; two pixels, TextOut, ExtTextOut and,
    with ``dib``, a 24-bit DIB stretched 10x."""
    xy = [int(v) for v in rng.integers(0, 1080, 26)]
    bmp = _dib24(rng.integers(0, 256, (24, 32, 3), np.uint8))
    recs = [_wmf_rec(0x020C, [1080, 1920]), _wmf_rec(0x020B, [0, 0]),
            _wmf_rec(0x02FA, [5, 1, 0, 0x3020, 0x0080]),
            _wmf_rec(0x02FA, [0, 3, 0, 0x00FF, 0x0000]),
            _wmf_rec(0x02FC, [0, 0x80C0, 0x0040]),
            _wmf_rec(0x02FC, [0, 0x2040, 0x00C0]),
            _wmf_rec(0x02FB, [-40] + [0] * 8, b"Arial\0"),
            _wmf_rec(0x012D, [0]), _wmf_rec(0x012D, [2]),
            _wmf_rec(0x012D, [4]), _wmf_rec(0x0209, [0x0000, 0x0080]),
            _wmf_rec(0x041B, [700, 900, 100, 80]),
            _wmf_rec(0x0324, [5] + xy[:10]),
            _wmf_rec(0x0538, [2, 3, 4] + xy[10:24]),
            _wmf_rec(0x012D, [3]),
            _wmf_rec(0x0418, [1000, 1800, 600, 1200]),
            _wmf_rec(0x061C, [60, 90, 1040, 700, 760, 150]),
            _wmf_rec(0x012D, [1]),
            _wmf_rec(0x0325, [4, 100, 1000, 500, 700, 900, 1000, 1300, 650]),
            _wmf_rec(0x0214, [50, 1850]), _wmf_rec(0x0213, [1030, 1100]),
            _wmf_rec(0x0213, [540, 30]),
            _wmf_rec(0x041F, [0x00FF, 0x0000, 20, 20]),
            _wmf_rec(0x041F, [0x0000, 0x00FF, 1060, 1900]),
            _wmf_rec(0x0521, [11], b"WMF at 1080" +
                     struct.pack("<hh", 80, 1300)),
            _wmf_rec(0x0A32, [200, 1300, 7, 0], b"records"),
            _wmf_rec(0x01F0, [2])]
    if dib:
        recs.append(_wmf_rec(0x0F43, [0x20, 0x00CC, 0, 24, 32, 0, 0, 240,
                                      320, 760, 1500], bmp))
    body = b"".join(recs) + _wmf_rec(0x0000, [])
    hdr = struct.pack("<HHHIHIH", 1, 9, 0x300, (18 + len(body)) // 2, 8, 0,
                      0)
    ph = (struct.pack("<IH4hH", 0x9AC6CDD7, 0, 0, 0, 1920, 1080, 72) +
          struct.pack("<IH", 0, 0))
    return ph + hdr + body, len(recs) + 1


def _emr(rtype: int, payload: bytes = b"") -> bytes:
    size = 8 + len(payload)
    pad = (-size) % 4
    return struct.pack("<II", rtype, size + pad) + payload + b"\0" * pad


def _emf_1080(rng, dib: bool = True) -> tuple:
    """An EMF whose frame decodes to 1920x1080 at 96 dpi, and its record
    count: a null and a solid pen, two brushes, a font; a rectangle, a
    polygon, a polypolygon, an ellipse and a round rect filled; a
    polyline, a Bezier, a line and a filled Bezier path; a pixel,
    ExtTextOutW and, with ``dib``, a 24-bit DIB stretched 8x
    (StretchDIBits)."""
    def pts(n):
        return b"".join(struct.pack("<2h", int(x), int(y)) for x, y in zip(
            rng.integers(0, 1920, n), rng.integers(0, 1080, n)))

    def poly(rtype, n):
        return _emr(rtype, struct.pack("<4iI", 0, 0, 1919, 1079, n) + pts(n))

    bmi_bits = _dib24(rng.integers(0, 256, (30, 40, 3), np.uint8))
    bmi, bits = bmi_bits[:40], bmi_bits[40:]
    text = "EMF at 1080"
    emrtext = struct.pack("<2iIII4iI", 1200, 100, len(text), 76, 0, 0, 0, 0,
                          0, 0)
    recs = [_emr(38, struct.pack("<IIiiI", 1, 5, 1, 0, 0x802010)),
            _emr(38, struct.pack("<IIiiI", 5, 0, 3, 0, 0x201080)),
            _emr(39, struct.pack("<IIII", 2, 0, 0x40C080, 0)),
            _emr(39, struct.pack("<IIII", 3, 0, 0xC04020, 0)),
            _emr(82, struct.pack("<Ii", 4, -48) + b"\0" * 24 +
                 "Arial".encode("utf-16le") + b"\0" * 54),
            _emr(37, struct.pack("<I", 1)), _emr(37, struct.pack("<I", 2)),
            _emr(43, struct.pack("<4i", 80, 100, 900, 700)), poly(86, 5),
            _emr(91, struct.pack("<4iII2I", 0, 0, 1919, 1079, 2, 7, 3, 4) +
                 pts(7)),
            _emr(37, struct.pack("<I", 3)),
            _emr(42, struct.pack("<4i", 1200, 600, 1800, 1000)),
            _emr(44, struct.pack("<6i", 700, 60, 1100, 500, 120, 80)),
            _emr(37, struct.pack("<I", 5)), poly(87, 5), poly(85, 7),
            _emr(27, struct.pack("<2i", 20, 1060)),
            _emr(54, struct.pack("<2i", 1900, 20)),
            _emr(59), _emr(27, struct.pack("<2i", 100, 900)), poly(88, 3),
            _emr(61), _emr(60), _emr(62, struct.pack("<4i", 0, 0, 1919, 1079)),
            _emr(15, struct.pack("<2iI", 10, 10, 0x0000FF)),
            _emr(24, struct.pack("<I", 0x000080)),
            _emr(37, struct.pack("<I", 4)),
            _emr(84, struct.pack("<4iI2f", 0, 0, 1919, 1079, 1, 1.0, 1.0) +
                 emrtext + text.encode("utf-16le")),
            _emr(40, struct.pack("<I", 2))]
    if dib:
        recs.append(_emr(81, struct.pack(
            "<4i6i4I2I2i", 0, 0, 1919, 1079, 1500, 700, 0, 0, 40, 30, 80, 40,
            120, len(bits), 0, 0x00CC0020, 320, 240) + bmi + bits))
    body = b"".join(recs) + _emr(14, struct.pack("<3I", 0, 16, 20))
    head = struct.pack("<4i4iIIIHHIII2i2i", 0, 0, 1919, 1079, 0, 0, 50800,
                       28575, 0x464D4520, 0x10000, 88 + len(body),
                       len(recs) + 2, 16, 0, 0, 0, 1920, 1080, 508, 286)
    return struct.pack("<II", 1, 8 + len(head)) + head + body, len(recs) + 2


def _sample_8bim() -> bytes:
    from imagemagick_tpu_torch.io import coders_r4b as t4b

    iptc = (b"\x1c\x02\x05" + struct.pack(">H", 4) + b"Scan" +
            b"\x1c\x02\x78" + struct.pack(">H", 12) + b"a caption \xe9&" +
            b"\x1c\x02\x19" + struct.pack(">H", 6) + b"survey")
    return t4b._build_8bim([(1028, "", iptc), (2000, "Path", b"\x01\x02abc"),
                            (1036, "", bytes(range(256)))])


def io_stream_phase(dev, gen, name_limit: str, seed: int) -> dict:
    """io_stream: the out-of-core tier on a 100-megapixel scan, and the
    last coders.  An 8-bit P6 of SCAN_H x SCAN_W x 3 from ``seed``
    through ``stream.convert_streaming`` (run (i): blur, level, unsharp,
    shape-preserving, 2 K3 launches a band, both memory peaks under the
    image's float32 size; run (ii): blur, level, a banded Lanczos resize
    to half, unsharp, 2 K3 launches an output band, held to the in-core
    route on the card within one 8-bit code, and a strip of it to the
    same run_chain on the CPU), ``outofcore.reduce_tiled`` of
    ``channel_histogram`` over ``stream.open_rows`` (one K4 launch a
    channel a band, equal to np.bincount); 1080p streams to PNG (8 and
    16 bits) and MIFF within one code of the CPU's, and ``read_stream``
    rows equal to ``read_images``; HDR, WMF, EMF, the META profiles,
    DMR, STRIMG, MATTE, DEBUG, JBIG and ``file:`` URLs decoded onto the
    card and encoded from it, against the CPU's; then ``cli.main.main``
    over 4 EMF and 4 WMF files through CLI_CODERS (one K1 launch) and 4
    PNG frames into and out of a DMR repository (one K1 launch)."""
    import tempfile

    from PIL import Image as PImage

    from imagemagick_tpu_torch import io as tio
    from imagemagick_tpu_torch import native as tnat
    from imagemagick_tpu_torch.core.image import Image as TImage
    from imagemagick_tpu_torch.core.spec import ImageSpec
    from imagemagick_tpu_torch.io import coders_r4b as t4b
    from imagemagick_tpu_torch.io import emf as temf
    from imagemagick_tpu_torch.io import stream as tst
    from imagemagick_tpu_torch.models import outofcore as toc
    from imagemagick_tpu_torch.ops import blur as tbl
    from imagemagick_tpu_torch.ops import enhance as ten
    from imagemagick_tpu_torch.ops import histogram as thist
    from imagemagick_tpu_torch.ops import resize as trz

    counts = {"k1": 0, "k3": 0, "k4": 0}
    full_f32 = SCAN_H * SCAN_W * C * 4
    band_f32 = STREAM_BAND * SCAN_W * C * 4
    mp = SCAN_H * SCAN_W / 1e6
    pre = [("blur", {"sigma": 2.0}), ("level", {"black": 0.05,
                                               "white": 0.95})]
    post = [("unsharp", {"sigma": 1.0})]
    with tempfile.TemporaryDirectory() as td:
        scan = os.path.join(td, "scan.ppm")
        t0 = time.perf_counter()
        _scan_ppm(scan, seed)
        print(f"io_stream: a {SCAN_H}x{SCAN_W}x{C} P6 scan from the seed "
              f"({os.path.getsize(scan)} bytes) written in "
              f"{time.perf_counter() - t0:.2f} s")

        # (i) the never-resident convert, shape-preserving
        out1 = os.path.join(td, "out.ppm")
        r1 = _stream_run(lambda: tst.convert_streaming(
            scan, out1, ops=pre + post, band_rows=STREAM_BAND, device=dev))
        bands = -(-SCAN_H // STREAM_BAND)
        require(r1["launches"]["k3"] == 2 * bands and
                r1["launches"]["k1"] == 0,
                f"io_stream (i) launches {r1['launches']}")
        require(r1["host"] < full_f32 and r1["card"] < full_f32,
                f"io_stream (i) peaks {r1['host']} / {r1['card']} bytes "
                f"against the image's {full_f32}")
        require(os.path.getsize(out1) == os.path.getsize(scan),
                "io_stream (i): the output's size")
        counts["k3"] += r1["launches"]["k3"]
        print(f"io_stream (i) convert_streaming blur 0x2 -> level 5%,95% -> "
              f"unsharp 0x1, {bands} bands of {STREAM_BAND} rows: "
              f"{r1['s']:.2f} s = {mp / r1['s']:.1f} MP/s; peaks: host "
              f"{r1['host'] / 1e6:.1f} MB (tracemalloc), card "
              f"{r1['card'] / 1e6:.1f} MB (max_memory_allocated), against "
              f"{full_f32 / 1e6:.1f} MB for the image as float32 and "
              f"{band_f32 / 1e6:.1f} MB a band; launches "
              f"{r1['launches']} [{name_limit}]")

        # (ii) the banded resize
        out2 = os.path.join(td, "out2.ppm")
        hout, wout = SCAN_H // 2, SCAN_W // 2
        r2 = _stream_run(lambda: tst.convert_streaming(
            scan, out2, ops=pre, resize=(hout, wout, "lanczos"),
            post_ops=post, band_rows=STREAM_BAND, device=dev))
        obands = -(-hout // STREAM_BAND)
        require(r2["launches"]["k3"] == 2 * obands and
                r2["launches"]["k1"] == 0,
                f"io_stream (ii) launches {r2['launches']}")
        counts["k3"] += r2["launches"]["k3"]
        print(f"io_stream (ii) convert_streaming blur -> level -> lanczos "
              f"{hout}x{wout} -> unsharp, {obands} output bands: "
              f"{r2['s']:.2f} s = {mp / r2['s']:.1f} MP/s in; peaks: host "
              f"{r2['host'] / 1e6:.1f} MB, card {r2['card'] / 1e6:.1f} MB "
              f"(the W operator alone {SCAN_W * wout * 4 / 1e6:.1f} MB "
              f"float32, on both); launches {r2['launches']} "
              f"[{name_limit}]")

        # (ii) against the in-core route on the card, quantized as the
        # writer quantizes
        reset_launches()
        t0 = time.perf_counter()
        x = torch.from_numpy(_ppm_body(scan).reshape(
            SCAN_H, SCAN_W, C)).to(dev).float() / 255.0
        x = tbl.gaussian_blur(x, 0.0, 2.0)
        x = ten.level(x, 0.05, 0.95, 1.0)
        x = trz.resize(x, hout, wout, "lanczos")
        x = tbl.unsharp_mask(x, 0.0, 1.0, 1.0, 0.05)
        q = (x.double() * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)
        incore = q.cpu().numpy().reshape(-1)
        torch.cuda.synchronize()
        incore_s = time.perf_counter() - t0
        counts["k3"] += launched()["k3"]
        del x, q
        banded = _ppm_body(out2)
        require(banded.shape == incore.shape, "io_stream (ii) sizes")
        codes = int(np.abs(banded.astype(np.int16) - incore).max())
        require(codes <= 1, f"io_stream (ii): {codes} codes from the "
                f"in-core route")
        print(f"io_stream (ii) against the in-core route on the card "
              f"(gaussian_blur -> level -> resize -> unsharp_mask on the "
              f"whole image, {incore_s:.2f} s with the read): at most "
              f"{codes} code apart, {np.mean(banded != incore):.2e} of the "
              f"samples moved [{name_limit}]")
        del banded, incore

        # (ii) on a strip: the card's run_chain against the CPU's
        loader, _ = tst.open_rows(scan)

        def strip(y0, y1):
            return loader(STRIP_Y0 + y0, STRIP_Y0 + y1)

        kw = dict(resize=(STRIP_ROWS // 2, wout, "lanczos"), post_ops=post,
                  band_rows=STREAM_BAND)
        reset_launches()
        got = toc.run_chain(strip, (STRIP_ROWS, SCAN_W, C), pre, device=dev,
                            **kw)
        torch.cuda.synchronize()
        counts["k3"] += launched()["k3"]
        t0 = time.perf_counter()
        want = toc.run_chain(strip, (STRIP_ROWS, SCAN_W, C), pre,
                             device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        err = float(np.abs(got - want).max())
        require(err <= STREAM_STRIP_TOL, f"io_stream strip max|d| {err}")
        print(f"io_stream (ii) on a strip of {STRIP_ROWS} rows: the card's "
              f"run_chain against the CPU's ({cpu_s:.1f} s): max|d| "
              f"{err:.3e} (tolerance {STREAM_STRIP_TOL}) [{name_limit}]")
        del got, want

        # a streaming statistic: K4 over the bands of the file
        reset_launches()
        t0 = time.perf_counter()
        hist = toc.reduce_tiled(
            loader, SCAN_H, thist.channel_histogram,
            lambda acc, part: acc + part.astype(np.int64),
            np.zeros((256, C), np.int64), band_rows=STREAM_BAND, device=dev)
        torch.cuda.synchronize()
        hist_s = time.perf_counter() - t0
        la = launched()
        require(la["k4"] == C * bands and la["k1"] == 0,
                f"io_stream reduce_tiled launches {la}")
        counts["k4"] += la["k4"]
        body = _ppm_body(scan).reshape(-1, C)
        for ch in range(C):
            require(np.array_equal(hist[:, ch], np.bincount(
                body[:, ch], minlength=256)),
                f"io_stream: channel {ch}'s histogram is not np.bincount's")
        del body
        print(f"io_stream reduce_tiled(open_rows(scan), channel_histogram): "
              f"{hist_s:.2f} s = {mp / hist_s:.1f} MP/s, {la['k4']} K4 "
              f"launches ({C} a band); the 256-bin counts equal "
              f"np.bincount of the file's bytes [{name_limit}]")
        os.remove(out1)
        os.remove(out2)

        # the other writers and readers at 1080p
        rng = np.random.default_rng(seed + 25)
        arr = _smooth_u8(rng, 1, IO_H, IO_W, C)[0]
        frame = TImage(arr.astype(np.float32) / 255.0,
                       ImageSpec(colorspace="srgb", depth=16), device="cpu")
        files = {"ppm": os.path.join(td, "f.ppm"),
                 "miff16": os.path.join(td, "f16.miff"),
                 "miff-float": os.path.join(td, "ff.miff")}
        PImage.fromarray(arr).save(files["ppm"])
        from imagemagick_tpu_torch.io import miff as tmiff

        for name, depth in (("miff16", 16), ("miff-float", 32)):
            with open(files[name], "wb") as f:
                f.write(tmiff.encode([frame], depth=depth,
                                     compression="none"))
        chain = [("negate", {}), ("level", {"black": 0.1, "white": 0.9})]
        for out, depth in (("o8.png", 8), ("o16.png", 16), ("o.miff", 16)):
            paths = []
            for d in (dev, "cpu"):
                paths.append(os.path.join(td, f"{d}-{out}".replace(":", "")))
                t0 = time.perf_counter()
                tst.convert_streaming(files["miff16"], paths[-1], ops=chain,
                                      band_rows=STREAM_BAND_1080,
                                      depth=depth, device=d)
                if d is dev:
                    ms = (time.perf_counter() - t0) * 1e3
            a, b = (tio.read_images(p, device="cpu")[0].data.numpy()
                    for p in paths)
            top = (1 << depth) - 1
            qa, qb = (np.round(v * top).astype(np.int64) for v in (a, b))
            codes = int(np.abs(qa - qb).max())
            require(a.shape == (IO_H, IO_W, C) and codes <= 1,
                    f"io_stream 1080p {out}: {codes} codes, {a.shape}")
            print(f"io_stream 16-bit MIFF {IO_H}x{IO_W}x{C} -> negate -> "
                  f"level -> {out} ({depth}-bit) on the card: {ms:.1f} ms; "
                  f"at most {codes} code from the CPU run, "
                  f"{np.mean(qa != qb):.2e} of the samples moved "
                  f"[{name_limit}]")
        for name, path in files.items():
            rows = []
            t0 = time.perf_counter()
            n = tst.read_stream(path, lambda b, y: rows.append(b),
                                rows_per_batch=STREAM_BAND_1080)
            ms = (time.perf_counter() - t0) * 1e3
            want = tio.read_images(path, device="cpu")[0].to_numpy()
            require(n == IO_H and np.array_equal(np.concatenate(rows), want),
                    f"io_stream read_stream {name}: not read_images' rows")
            print(f"io_stream read_stream {name} {IO_H}x{IO_W}x{C}: "
                  f"{ms:.1f} ms, {len(rows)} batches, the rows equal to "
                  f"read_images' [{name_limit}]")

        # the coders: decode onto the card and encode from it
        radiance = TImage(16.0 * (arr.astype(np.float32) / 255.0) ** 2,
                          ImageSpec(colorspace="rgb", depth=16),
                          device="cpu")
        gray_hdr = TImage(radiance.data[..., :1].clone(),
                          ImageSpec(colorspace="gray", depth=16),
                          device="cpu")
        small = TImage(frame.data[:SMALL4[0], :SMALL4[1]].clone(),
                       ImageSpec(colorspace="srgb", depth=16), device="cpu")
        rgba = TImage(torch.cat([small.data, small.data[..., 1:2]], -1),
                      ImageSpec(colorspace="srgb", alpha=True, depth=16),
                      device="cpu")

        def coder(name, encode, decode, image, hold=None, encodes=True):
            blob = encode(image)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = decode(blob, dev)
            torch.cuda.synchronize()
            dec_ms = (time.perf_counter() - t0) * 1e3
            want = decode(blob, "cpu")
            require(img.data.device == torch.device(dev),
                    f"io_stream {name}: not on the card")
            if hold is None:
                require(torch.equal(img.data.cpu(), want.data),
                        f"io_stream {name}: the card's decode is not the "
                        f"CPU's")
                held = "the decode equal to the CPU's"
            else:
                held = hold(img, want)
            shape = "x".join(map(str, img.data.shape))
            if not encodes:
                print(f"io_stream {name} to {shape} ({len(blob)} bytes): "
                      f"decode to the card {dec_ms:.4f} ms (one run, host "
                      f"clock); {held} [{name_limit}]")
                return img
            t0 = time.perf_counter()
            got = encode(TImage(image.data.to(dev), image.spec))
            enc_ms = (time.perf_counter() - t0) * 1e3
            require(got == blob, f"io_stream {name}: the card's encode is "
                    f"not the CPU's")
            print(f"io_stream {name} {shape} ({len(blob)} bytes): decode to "
                  f"the card {dec_ms:.4f} ms, encode from it {enc_ms:.4f} ms "
                  f"(one run each, host clock); {held}, the encode's bytes "
                  f"the CPU's [{name_limit}]")
            return img

        def blob_of(fmt):
            return lambda b, d: tio.image_from_blob(b, fmt, device=d)[0]

        coder("hdr rgb", lambda im: tio.image_to_blob(im, "hdr"),
              blob_of("hdr"), radiance)
        coder("hdr gray", lambda im: tio.image_to_blob(im, "hdr"),
              blob_of("hdr"), gray_hdr)
        coder("strimg", lambda im: tio.image_to_blob(im, "strimg"),
              blob_of("strimg"), TImage(frame.data[:1, :200].clone(),
                     ImageSpec(colorspace="srgb", depth=8), device="cpu"))
        coder("matte", lambda im: tio.image_to_blob(im, "matte"),
              blob_of("miff"), rgba)
        t0 = time.perf_counter()
        dbg = tio.image_to_blob(TImage(small.data.to(dev), small.spec),
                                "debug")
        dbg_ms = (time.perf_counter() - t0) * 1e3
        require(dbg == tio.image_to_blob(small, "debug"),
                "io_stream debug: the card's text is not the CPU's")
        lines = dbg.count(b"\n")
        print(f"io_stream debug {SMALL4[0]}x{SMALL4[1]}x{C} from the card: "
              f"{lines} lines ({len(dbg)} bytes) in {dbg_ms:.1f} ms, the "
              f"CPU's bytes [{name_limit}]")
        bim = _sample_8bim()
        metas = {"8bim": bim, "8bimtext": t4b.format_8bimtext(bim).encode(),
                 "iptc": t4b.iptc_from_8bim(bim),
                 "iptctext": t4b.format_iptctext(
                     t4b.iptc_from_8bim(bim)).encode(),
                 "exif": b"Exif\0\0MM\0*\0\0\0\x08\0\0",
                 "xmp": b"<?xpacket begin=''?><x:xmpmeta "
                        b"xmlns:x='adobe:ns:meta/'/>",
                 "icc": bytes(range(256)) * 2}
        for fmt, blob in metas.items():
            img = tio.image_from_blob(blob, fmt, device=dev)[0]
            out = tio.image_to_blob(img, fmt)
            require(img.data.is_cuda and img.data.shape == (1, 1, 3) and
                    out == blob and out == tio.image_to_blob(
                        tio.image_from_blob(blob, fmt, device="cpu")[0], fmt),
                    f"io_stream meta {fmt}")
        print(f"io_stream META {', '.join(metas)}: the 1x1 image on the "
              f"card, each profile's bytes back unchanged and the CPU's "
              f"[{name_limit}]")
        metafiles = {}
        for name, make in (("wmf", _wmf_1080), ("emf", _emf_1080)):
            blob, nrec = make(rng)
            metafiles[name] = blob

            def hold(img, want, name=name):
                err, n_off, n_px = _apart(img.data, want.data, DRAW_TOL)
                require(img.data.shape[:2] == (IO_H, IO_W) and
                        err <= DRAW_TOL, f"io_stream {name} max|d| {err} "
                        f"{tuple(img.data.shape)}")
                return (f"{nrec} records; against the CPU's decode max|d| "
                        f"{err:.3e}, {n_off} of {n_px} px apart by more "
                        f"than {DRAW_TOL}")
            coder(name, lambda im, b=blob: b, blob_of(name), frame, hold,
                  encodes=False)
        for pp in (None, "a passphrase"):
            st = {"defines": {"dmr:path": os.path.join(td, "repo")}}
            if pp:
                st["defines"]["dmr:passphrase"] = pp
            batch = [TImage(small.data.to(dev) * (k + 1) / DMR_FRAMES,
                            small.spec) for k in range(DMR_FRAMES)]
            t0 = time.perf_counter()
            tio.write_image(batch, "dmr:image/smoke/batch", settings=st)
            w_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            back = tio.read_images("dmr:image/smoke/batch", settings=st,
                                   device=dev)
            r_ms = (time.perf_counter() - t0) * 1e3
            cpu = tio.read_images("dmr:image/smoke/batch", settings=st,
                                  device="cpu")
            require(len(back) == DMR_FRAMES and all(
                b.data.is_cuda and torch.equal(b.data.cpu(), c.data)
                for b, c in zip(back, cpu)), "io_stream dmr")
            print(f"io_stream dmr {DMR_FRAMES} frames of {SMALL4[0]}x"
                  f"{SMALL4[1]}x{C} {'with' if pp else 'without'} a "
                  f"passphrase: write {w_ms:.1f} ms, read onto the card "
                  f"{r_ms:.1f} ms, equal to the CPU's read [{name_limit}]")
        if tnat.jbig_available():
            coder("jbig", lambda im: tio.image_to_blob(im, "jbig"),
                  blob_of("jbig"), gray_hdr)
        else:
            try:
                tio.image_to_blob(small, "jbig")
                why = None
            except ValueError as exc:
                why = str(exc)
            require(why is not None and "libjbig" in why,
                    "io_stream jbig: no ValueError without libjbig")
            print(f"io_stream jbig: libjbig does not build here: the JAX "
                  f"ValueError ({why})")
        png = os.path.join(td, "u.png")
        PImage.fromarray(arr).save(png)
        got = tio.read_images("file://" + png, device=dev)[0]
        require(got.data.is_cuda and torch.equal(
            got.data.cpu(), tio.read_images(png, device="cpu")[0].data),
            "io_stream file: URL")
        print(f"io_stream file:// URL of a {IO_H}x{IO_W} PNG: read onto the "
              f"card, equal to the file's read [{name_limit}]")

        # (a) metafiles through the CLI, (b) a DMR repository.  A DIB's
        # composite leaves a 4th channel on the canvas, as the JAX coders
        # do, which K1's gray mix does not take: the CLI's files carry no
        # DIB record, so they decode to RGB
        plain = {"wmf": _wmf_1080(rng, dib=False)[0],
                 "emf": _emf_1080(rng, dib=False)[0]}
        names = []
        for k in range(CLI_METAFILES):
            for kind in ("emf", "wmf"):
                names.append(os.path.join(td, f"m{k}.{kind}"))
                with open(names[-1], "wb") as f:
                    f.write(plain[kind])
        outs = {}
        for d in (dev, "cpu"):
            out = os.path.join(td, f"meta-{torch.device(d).type}-%d.png")
            reset_launches()
            t0 = time.perf_counter()
            _main_ok(names + CLI_CODERS + [out], d)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            outs[d] = (out, launched(), wall)
        la = outs[dev][1]
        # one group: the 8 images share their shape
        require(la["k1"] == 1, f"io_stream cli metafiles launches {la}")
        counts["k1"] += la["k1"]
        codes = 0
        moved = []
        for k in range(len(names)):
            a, b = (np.asarray(PImage.open(outs[d][0] % k), np.int16)
                    for d in (dev, "cpu"))
            codes = max(codes, int(np.abs(a - b).max()))
            moved.append(np.mean(a != b))
        require(codes <= 1, f"io_stream cli metafiles: {codes} codes")
        print(f"io_stream cli: {CLI_METAFILES} EMF and {CLI_METAFILES} WMF "
              f"of {IO_H}x{IO_W} -> {' '.join(CLI_CODERS)} -> out-%d.png: "
              f"launches {la} (the files without their DIB record: a DIB's "
              f"composite leaves a 4th channel, as in the JAX coders, which "
              f"K1's gray mix does not take), {outs[dev][2]:.1f} ms (first "
              f"run); at most "
              f"{codes} code from the CPU run, {np.mean(moved):.2e} of the "
              f"samples moved [{name_limit}]")
        pngs = []
        for k in range(CLI_METAFILES):
            pngs.append(os.path.join(td, f"p{k}.png"))
            PImage.fromarray(_smooth_u8(rng, 1, IO_H, IO_W, C)[0]).save(
                pngs[-1])
        backs = {}
        for d in (dev, "cpu"):
            repo = os.path.join(td, f"repo-{torch.device(d).type}")
            defs = ["-define", f"dmr:path={repo}", "-define",
                    "dmr:passphrase=smoke"]
            reset_launches()
            t0 = time.perf_counter()
            _main_ok(defs + pngs + CLI_CODERS + ["dmr:image/batch"], d)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            la = launched()
            out = os.path.join(td, f"back-{torch.device(d).type}-%d.png")
            _main_ok(defs + ["dmr:image/batch", out], d)
            backs[d] = (out, la, wall)
        la = backs[dev][1]
        require(la["k1"] == 1, f"io_stream cli dmr launches {la}")
        counts["k1"] += la["k1"]
        codes = 0
        for k in range(CLI_METAFILES):
            a, b = (np.asarray(PImage.open(backs[d][0] % k), np.int16)
                    for d in (dev, "cpu"))
            require(a.shape == (IO_H // 2, IO_W // 2), f"dmr {a.shape}")
            codes = max(codes, int(np.abs(a - b).max()))
        require(codes <= 1, f"io_stream cli dmr: {codes} codes")
        print(f"io_stream cli: {CLI_METAFILES} PNG of {IO_H}x{IO_W} -> "
              f"{' '.join(CLI_CODERS)} -> dmr:image/batch (enciphered) and "
              f"back: launches {la}, {backs[dev][2]:.1f} ms (first run); "
              f"at most {codes} code from the CPU run [{name_limit}]")
    print(f"io_stream launches to add: {counts}")
    return counts


class _Stdout:
    """A stdout stand-in whose ``buffer`` collects bytes (the sixel route
    writes there)."""

    def __init__(self):
        self.buffer = io.BytesIO()

    def write(self, text):
        self.buffer.write(text.encode())

    def flush(self):
        pass

    def isatty(self):
        return False


def _run_main(argv, device):
    """(exit code, stdout bytes, stderr text) of ``main(argv, device)``."""
    from imagemagick_tpu_torch.cli.main import main as cli_main

    out, err = _Stdout(), io.StringIO()
    old = sys.stdout
    sys.stdout = out
    try:
        with contextlib.redirect_stderr(err):
            rc = cli_main(list(argv), device=device)
    finally:
        sys.stdout = old
    torch.cuda.synchronize()
    return rc, out.buffer.getvalue(), err.getvalue()


def _png_levels(a: str, b: str) -> int:
    """The largest difference, in 8-bit levels, of two PNG files' samples
    (their shapes equal)."""
    from PIL import Image as PImage

    x = np.asarray(PImage.open(a)).astype(np.int64)
    y = np.asarray(PImage.open(b)).astype(np.int64)
    require(x.shape == y.shape, f"{a} {x.shape} against {b} {y.shape}")
    return int(np.abs(x - y).max())


def step_cycles(dev) -> float:
    """The SM cycles of one palette-walk step at its narrowest (C = 1,
    K = 32: a shared-memory load of the entry the step before chose, one
    distance, five shuffle levels), measured by the kernel library's
    pw_step_cycles over STEP_CHAIN dependent steps on one warp (clock64);
    the least of three runs after a first."""
    from imagemagick_tpu_torch import _build

    lib = _build.load()
    pal = torch.rand(32, device=dev)
    cycles = torch.zeros(2, dtype=torch.int64, device=dev)
    runs = []
    for _ in range(4):
        _build.check(lib.pw_step_cycles(
            pal.data_ptr(), STEP_CHAIN, cycles.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "pw_step_cycles")
        torch.cuda.synchronize(dev)
        runs.append(int(cycles[0]) / STEP_CHAIN)
    return min(runs[1:])


def walk_bound(n: int, h: int, w: int, c: int, k: int, cycles: float):
    """A palette walk's least time on the card (ms), what binds it and
    the SM clock: the larger of its bytes (each input read once, each
    output written once), its float32 operations (3 a channel an entry a
    pixel: the distance's subtract, multiply and add) and its chain of
    h*w dependent steps at ``cycles`` each (``step_cycles``) and the
    card's top SM clock; the n images run side by side on n SMs.  The
    chain is a latency, reported under "operations", the contract's word
    for a bound that is not bytes: dependent operations, each waiting
    for the one before."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.split()[0])
    t_chain = h * w * cycles / (mhz * 1e6) * 1e3
    t_other, by = bound(2 * n * h * w * c * 4 + k * c * 4,
                        3.0 * n * h * w * c * k)
    return (t_chain, "operations", mhz) if t_chain >= t_other else \
        (t_other, by, mhz)


def _palette_hits(out: torch.Tensor, pal: torch.Tensor) -> bool:
    """Whether every pixel of ``out`` is an entry of ``pal``, by a hash of
    each entry's float32 bits."""
    def key(v):
        bits = v.contiguous().view(torch.int32).to(torch.int64)
        h = torch.zeros(v.shape[:-1], dtype=torch.int64, device=v.device)
        for i in range(v.shape[-1]):
            h = h * 1000003 + bits[..., i]
        return h
    return bool(torch.isin(key(out), key(pal)).all())


def cli_tools_phase(dev, gen, name_limit: str, seed: int) -> dict:
    """cli_tools: the CLI's other tools, -region, -bench and the palette
    walks on the card.  mogrify -path -format png of TOOLS_FILES PNGs of
    512x768x3 through config #1's chain (K1 once a file, each output the
    bytes the port's convert writes for the file); composite of a 1080p
    destination and an RGBA overlay (-gravity center -geometry +10+10),
    montage of 16 tiles (-tile 4x4 -geometry 256x256+4+4) and an MSL
    script (read a 1080p PNG, resize, blur, write) by conjure, each
    within one level of the CPU run; compare -metric rmse, psnr and ncc
    of two 1080p frames and -subimage-search of a 64x64 patch in 540x960
    (numbers and exit codes against the CPU run); identify -format of a
    1080p frame and stream -extract 1920x1080+0+0 of a 3840x2160 PNG
    (the CPU's text and bytes); -region 800x600+100+100 -gaussian-blur
    0x2 on a 1080p frame through K3 (outside equal to the input, inside
    within EFFECT_TOL of the CPU); -bench 5 of config #1's chain; display
    to a file and as sixel.  The walks: each kernel equal to its plain
    version bit for bit on 2 x 48x63 frames at C = 1, 3, 4 and palettes of
    2, 16, 256 entries, inputs in [-0.3, 1.3]; remap(..., dither=True)
    of 4 x 1080x1920x3 with 16 and 256 entries (one Floyd-Steinberg
    launch each; the first WALK_TOP rows equal the plain walk of the
    input's first rows, every pixel a palette entry); Riemersma on 1 x
    256x256x3 equal to its plain version.  The plain versions run on CPU
    copies of the inputs: the same float32 operations."""
    import tempfile

    from PIL import Image as PImage

    from imagemagick_tpu_torch.cli import main as tm
    from imagemagick_tpu_torch.cli import tools as tt
    from imagemagick_tpu_torch.core.image import Image as TImage
    from imagemagick_tpu_torch.ops import quantize as tq

    rng = np.random.default_rng(seed + 25)
    counts = {"k1": 0, "k3": 0, "walk_fs": 0, "walk_riemersma": 0}

    def frame(h, w, c=3):
        """Smooth u8 content with texture, so that resamples and blurs
        have something to do."""
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = 0.5 + 0.4 * np.sin(yy / 37.0)[..., None] * np.cos(
            xx[..., None] / 53.0 + np.arange(c))
        img = base + 0.05 * rng.standard_normal((h, w, c))
        return (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)

    with tempfile.TemporaryDirectory() as td:
        def path(name):
            return os.path.join(td, name)

        # -- mogrify against convert, file by file ----------------------
        names = []
        for k in range(TOOLS_FILES):
            names.append(path(f"m{k}.png"))
            PImage.fromarray(frame(H, W)).save(names[-1])
        os.mkdir(path("mog"))
        reset_launches()
        t0 = time.perf_counter()
        rc, _, err = _run_main(["mogrify", "-path", path("mog"), "-format",
                                "png", *CLI_ARGV, *names], dev)
        mog_s = time.perf_counter() - t0
        la = launched()
        require(rc == 0 and err == "", f"mogrify: {rc} {err}")
        require(la["k1"] == TOOLS_FILES, f"mogrify K1 launches {la}")
        counts["k1"] += la["k1"]
        for k, name in enumerate(names):
            conv = path(f"c{k}.png")
            _main_ok([name, *CLI_ARGV, conv], dev)
            with open(conv, "rb") as f, \
                    open(os.path.join(path("mog"), f"m{k}.png"), "rb") as g:
                require(f.read() == g.read(), f"mogrify file {k}: not the "
                        "bytes convert writes")
        print(f"cli_tools mogrify {TOOLS_FILES} PNGs of {H}x{W}x{C}: "
              f"{mog_s * 1e3 / TOOLS_FILES:.1f} ms a file, K1 {la['k1']}, "
              f"each the bytes of convert's [{name_limit}]")

        # -- composite, montage, conjure against the CPU ------------------
        PImage.fromarray(frame(IO_H, IO_W)).save(path("dst.png"))
        PImage.fromarray(frame(256, 384, 4)).save(path("ov.png"))
        tiles = []
        for k in range(TOOLS_TILES):
            tiles.append(path(f"t{k}.png"))
            PImage.fromarray(frame(300 + 7 * k, 400)).save(tiles[-1])
        with open(path("s.msl"), "w") as f:
            f.write(f'<image><read filename="{path("dst.png")}"/>'
                    f'<resize geometry="50%"/><blur radius="0" sigma="2"/>'
                    f'<write filename="{path("msl-OUT.png")}"/></image>')
        with open(path("s.msl")) as f:
            msl = f.read()
        runs = {
            "composite": lambda o: ["composite", "-gravity", "center",
                                    "-geometry", "+10+10", path("ov.png"),
                                    path("dst.png"), o],
            "montage": lambda o: ["montage", *tiles, "-tile", "4x4",
                                  "-geometry", "256x256+4+4", o],
            "conjure": None,
        }
        for tool, argv in runs.items():
            outs = {}
            for d, side in ((dev, "card"), ("cpu", "cpu")):
                o = path(f"{tool}-{side}.png")
                if tool == "conjure":
                    with open(path("s.msl"), "w") as f:
                        f.write(msl.replace(path("msl-OUT.png"), o))
                    args = ["conjure", path("s.msl")]
                else:
                    args = argv(o)
                reset_launches()
                t0 = time.perf_counter()
                rc, _, err = _run_main(args, d)
                ms = (time.perf_counter() - t0) * 1e3
                require(rc == 0 and err == "", f"{tool}: {rc} {err}")
                if d == dev:
                    la = launched()
                    counts["k1"] += la["k1"]
                    counts["k3"] += la["k3"]
                    card_ms = ms
                outs[side] = o
            lv = _png_levels(outs["card"], outs["cpu"])
            require(lv <= 1, f"{tool}: {lv} levels from the CPU run")
            shape = np.asarray(PImage.open(outs["card"])).shape
            print(f"cli_tools {tool} -> {shape}: {card_ms:.1f} ms on the "
                  f"card, within {lv} level of the CPU run, launches "
                  f"{ {k: v for k, v in la.items() if v} } [{name_limit}]")

        # -- compare, identify, stream against the CPU --------------------
        a = frame(IO_H, IO_W)
        b = np.clip(a.astype(np.int64) + rng.integers(-3, 4, a.shape), 0,
                    255).astype(np.uint8)
        PImage.fromarray(a).save(path("ca.png"))
        PImage.fromarray(b).save(path("cb.png"))
        # noise: the unnormalized correlation that similarity_image takes
        # peaks at the patch only where the frame has no large shading
        half = rng.integers(0, 256, (IO_H // 2, IO_W // 2, C), np.uint8)
        PImage.fromarray(half).save(path("half.png"))
        py, px = IO_H // 6, IO_W // 6
        PImage.fromarray(half[py:py + PATCH, px:px + PATCH]).save(
            path("patch.png"))
        number = re.compile(r"[-+0-9.einf]+")
        for argv, rel in (
                (["compare", "-metric", "rmse", path("ca.png"),
                  path("cb.png")], TOOLS_COMPARE_REL),
                (["compare", "-metric", "psnr", path("ca.png"),
                  path("cb.png")], TOOLS_COMPARE_REL),
                (["compare", "-metric", "ncc", path("ca.png"),
                  path("cb.png")], TOOLS_COMPARE_REL),
                (["compare", "-metric", "rmse", path("ca.png"),
                  path("ca.png")], TOOLS_COMPARE_REL),
                (["compare", "-subimage-search", path("half.png"),
                  path("patch.png")], TOOLS_SEARCH_REL)):
            t0 = time.perf_counter()
            rc, _, err = _run_main(argv, dev)
            ms = (time.perf_counter() - t0) * 1e3
            rc_cpu, _, err_cpu = _run_main(argv, "cpu")
            require(rc == rc_cpu, f"compare {argv[1:3]}: exit {rc} on the "
                    f"card, {rc_cpu} on the CPU")
            got = [float(v) for v in number.findall(err.split("@")[0])]
            want = [float(v) for v in number.findall(err_cpu.split("@")[0])]
            # ncc prints 1 - corr: its tolerance is relative to corr, so
            # absolute on d (and on 65535·d, 65535 times it)
            scale = [65535.0, 1.0] if argv[2] == "ncc" else [0.0, 0.0]
            require(len(got) == len(want) and all(
                abs(g - w) <= rel * max(abs(w), sc, 1e-12)
                for g, w, sc in zip(got, want, scale + [0.0] * len(want))),
                f"compare {argv[1:3]}: {err!r} against {err_cpu!r}")
            if "@" in err:
                require(err.split("@")[1] == err_cpu.split("@")[1] ==
                        f" {px},{py}\n", f"subimage search: {err!r}, the "
                        f"CPU {err_cpu!r}")
            print(f"cli_tools {' '.join(argv[1:3])}: {err.strip()!r} exit "
                  f"{rc} (the CPU: {err_cpu.strip()!r} exit {rc_cpu}), "
                  f"{ms:.1f} ms [{name_limit}]")
        fmt = "%w %h %m %[fx:w*h] %k\\n"
        rc, out, _ = _run_main(["identify", "-format", fmt, path("ca.png")],
                               dev)
        rc_cpu, out_cpu, _ = _run_main(["identify", "-format", fmt,
                                        path("ca.png")], "cpu")
        require(rc == rc_cpu == 0 and out == out_cpu and out,
                f"identify: {out!r} against {out_cpu!r}")
        print(f"cli_tools identify -format: {out.decode().strip()!r}, the "
              f"CPU's text [{name_limit}]")
        PImage.fromarray(frame(2 * IO_H, 2 * IO_W)).save(path("uhd.png"))
        raws = []
        for d, side in ((dev, "card"), ("cpu", "cpu")):
            raw = path(f"s-{side}.raw")
            t0 = time.perf_counter()
            rc, _, err = _run_main(["stream", "-extract",
                                    f"{IO_W}x{IO_H}+0+0", path("uhd.png"),
                                    raw], d)
            ms = (time.perf_counter() - t0) * 1e3
            require(rc == 0 and err == "", f"stream: {rc} {err}")
            with open(raw, "rb") as f:
                raws.append(f.read())
            if d == dev:
                stream_ms = ms
        require(raws[0] == raws[1] and len(raws[0]) == IO_H * IO_W * C,
                "stream: the card's bytes are not the CPU's")
        print(f"cli_tools stream -extract {IO_W}x{IO_H}+0+0 of "
              f"{2 * IO_W}x{2 * IO_H}: {stream_ms:.1f} ms, the CPU's "
              f"{len(raws[0])} bytes [{name_limit}]")

        # -- -region through K3 --------------------------------------------
        x = torch.from_numpy(a.astype(np.float32) / 255.0)
        res = {}
        for d, side in ((dev, "card"), ("cpu", "cpu")):
            st = tm.CLIState(d)
            st.images.append(tm.LazyImage(TImage(x.to(d))))
            reset_launches()
            t0 = time.perf_counter()
            tm.process(["-region", REGION, "-gaussian-blur", "0x2"], st)
            res[side] = tm.materialize_all(st.images)[0].data
            torch.cuda.synchronize()
            if d == dev:
                region_ms = (time.perf_counter() - t0) * 1e3
                la = launched()
                require(la["k3"] == 1 and la["k1"] == 0,
                        f"-region blur launches {la}")
                counts["k3"] += la["k3"]
        rw, rh, rx, ry = map(int, re.findall(r"\d+", REGION))
        inside = torch.zeros(IO_H, IO_W, dtype=torch.bool)
        inside[ry:ry + rh, rx:rx + rw] = True
        got = res["card"].cpu()
        require(torch.equal(got[~inside], x[~inside]),
                "-region: a pixel outside the region changed")
        err = max_err(got[inside], res["cpu"][inside])
        require(err <= EFFECT_TOL and not torch.equal(got[inside],
                                                      x[inside]),
                f"-region inside: max|d| {err}")
        print(f"cli_tools -region {REGION} -gaussian-blur 0x2 on {IO_H}x"
              f"{IO_W}x{C}: {region_ms:.1f} ms, K3 1, outside equal, inside "
              f"max|d| {err:.3e} [{name_limit}]")

        # -- -bench ----------------------------------------------------------
        reset_launches()
        rc, _, err = _run_main(["-bench", str(TOOLS_BENCH), names[0],
                                *CLI_ARGV, path("bench.png")], dev)
        la = launched()
        m = re.fullmatch(r"Performance\[1\]: (\d+)i ([0-9.]+)ips 1\.000e "
                         r"([0-9.]+)u \d+:\d{2}\.\d{3}\n", err)
        require(rc == 0 and m is not None and int(m.group(1)) == TOOLS_BENCH
                and la["k1"] == TOOLS_BENCH, f"-bench: {rc} {err!r} {la}")
        counts["k1"] += la["k1"]
        print(f"cli_tools -bench {TOOLS_BENCH} of config #1's chain on one "
              f"{H}x{W} PNG: {err.strip()!r} (K1 {la['k1']}) [{name_limit}]")

        # -- display: the file route and the sixel route --------------------
        keep = tt.DISPLAY_FILE, os.environ.get("IMTPU_SIXEL")
        try:
            tt.DISPLAY_FILE = path("display.png")
            os.environ.pop("IMTPU_SIXEL", None)
            rc, _, err = _run_main(["display", path("ca.png"), "-negate"],
                                   dev)
            require(rc == 0 and err == "display: no sixel terminal; wrote "
                    f"{tt.DISPLAY_FILE}\n", f"display: {rc} {err!r}")
            neg = np.asarray(PImage.open(tt.DISPLAY_FILE))
            require(np.array_equal(neg, 255 - a), "display file: not -negate")
            os.environ["IMTPU_SIXEL"] = "1"
            rc, out, err = _run_main(["display", path("ca.png")], dev)
            rc_cpu, out_cpu, _ = _run_main(["display", path("ca.png")],
                                           "cpu")
            shown = round(IO_H * 800 / IO_W) if IO_W > 800 else IO_H
            bands = -(-shown // 6)
            require(rc == rc_cpu == 0 and out.startswith(b"\x1bPq") and
                    out.endswith(b"\x1b\\\n") and out.count(b"-") == bands,
                    f"display sixel: {rc} {out[:16]!r} {out.count(b'-')}")
        finally:
            tt.DISPLAY_FILE = keep[0]
            if keep[1] is None:
                os.environ.pop("IMTPU_SIXEL", None)
            else:
                os.environ["IMTPU_SIXEL"] = keep[1]
        print(f"cli_tools display: a file, and {len(out)} bytes of sixel "
              f"in {bands} bands ({'the' if out == out_cpu else 'not the'} "
              f"CPU run's bytes) [{name_limit}]")

    # -- the palette walks ---------------------------------------------------
    small = {}
    for c in (1, 3, 4):
        for k in (2, 16, 256):
            xs = torch.from_numpy((rng.random((*WALK_SMALL, c)) * 1.6 - 0.3)
                                  .astype(np.float32))
            pal = torch.from_numpy(rng.random((k, c)).astype(np.float32))
            for fn in (tq.floyd_steinberg, tq.riemersma):
                t0 = time.perf_counter()
                got = fn(xs.to(dev), pal.to(dev))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                want = fn(xs, pal)
                plain_ms = (time.perf_counter() - t0) * 1e3
                require(torch.equal(got.cpu(), want),
                        f"{fn.__name__} C={c} K={k}: not the plain walk")
                if (c, k) == (3, 16):
                    small[fn.__name__] = (ms, plain_ms)
    print(f"walks on {WALK_SMALL[0]} x {WALK_SMALL[1]}x{WALK_SMALL[2]} at "
          f"C = 1, 3, 4 with 2, 16, 256 entries: both equal to their plain "
          f"versions; C=3 K=16: {small} (kernel ms, plain ms on the host) "
          f"[{name_limit}]")

    cycles = step_cycles(dev)
    print(f"walk step at C = 1, K = 32: {cycles:.2f} SM cycles "
          f"(pw_step_cycles, {STEP_CHAIN} dependent steps) [{name_limit}]")
    xb = torch.rand(WALK_N, IO_H, IO_W, C, generator=gen, device=dev)
    top = xb[:, :WALK_TOP].cpu()
    fs = {}
    for k in (16, 256):
        pal = torch.rand(k, C, generator=gen, device=dev)
        reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = tq.remap(xb, pal, dither=True)
        end.record()
        end.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        dev_ms = start.elapsed_time(end)
        la = launched()
        require(la["walk_fs"] == 1 and sum(la.values()) == 1,
                f"remap dither launches {la}")
        counts["walk_fs"] += 1
        t0 = time.perf_counter()
        want = tq._floyd_steinberg_plain(top, pal.cpu())
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((out[:, :WALK_TOP].cpu() - want).abs().max())
        require(torch.equal(out[:, :WALK_TOP].cpu(), want),
                f"remap dither K={k}: the first rows are not the plain walk "
                f"({err})")
        require(_palette_hits(out, pal), f"remap dither K={k}: a pixel "
                "that is no palette entry")
        fs[k] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                 "launches": la["walk_fs"], "max_abs_err": err,
                 "bound": walk_bound(WALK_N, IO_H, IO_W, C, k, cycles)}
        print(f"walk_fs remap(dither=True) {(WALK_N, IO_H, IO_W, C)} onto "
              f"{k} entries: {ms:.1f} ms ({dev_ms:.1f} ms on CUDA events), "
              f"bound {fs[k]['bound'][0]:.1f} ms ({fs[k]['bound'][1]}, "
              f"{fs[k]['bound'][2]:.0f} MHz); plain walk of the first "
              f"{WALK_TOP} rows {plain_ms:.0f} ms on the host, equal "
              f"[{name_limit}]")
    xr = torch.rand(1, WALK_SIDE, WALK_SIDE, C, generator=gen, device=dev)
    pal = torch.rand(16, C, generator=gen, device=dev)
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    got = tq.riemersma(xr, pal)
    end.record()
    end.synchronize()
    rm_ms = (time.perf_counter() - t0) * 1e3
    rm_dev = start.elapsed_time(end)
    rm_launches = launched()["walk_riemersma"]
    require(rm_launches == 1, "riemersma launches")
    counts["walk_riemersma"] += 1
    t0 = time.perf_counter()
    want = tq.riemersma(xr.cpu(), pal.cpu())
    rm_plain = (time.perf_counter() - t0) * 1e3
    rm_err = float((got.cpu() - want).abs().max())
    require(torch.equal(got.cpu(), want),
            f"riemersma: not the plain walk ({rm_err})")
    rm_bound = walk_bound(1, WALK_SIDE, WALK_SIDE, C, 16, cycles)
    print(f"walk_riemersma {(1, WALK_SIDE, WALK_SIDE, C)} onto 16 entries: "
          f"{rm_ms:.2f} ms ({rm_dev:.2f} ms on CUDA events), bound "
          f"{rm_bound[0]:.2f} ms ({rm_bound[1]}); plain {rm_plain:.0f} ms on "
          f"the host, equal [{name_limit}]")
    counts["walks"] = {"fs": fs, "fs_small": small["floyd_steinberg"],
                       "rm": (rm_ms, rm_dev, rm_plain, rm_bound),
                       "rm_launches": rm_launches, "rm_err": rm_err,
                       "rm_small": small["riemersma"],
                       "step_cycles": cycles}
    return counts



def wand_phase(dev, gen, name_limit: str, seed: int) -> dict:
    """wand: the MagickWand API on the card.  A 1080x1920x3 PPM read into
    a wand on the card, ``resize_image(960, 540)`` then
    ``gaussian_blur_image(0, 2)`` (one K1 launch each, a tagged method
    each) and ``write_image`` to a 16-bit PPM; the pixels within K1_TOL of
    the same chain on a ``device="cpu"`` wand (K1's plain version) and the
    written samples within one level.  ``blur_image`` of a frame with a
    non-opaque alpha (K3, within K3_TOL of the CPU wand) and
    ``auto_threshold_image("otsu")`` of a page (one K4 launch, equal);
    ``remap_image`` of a 2-frame batch onto 16 entries under a dither
    (one Floyd-Steinberg walk launch, equal).
    Then a PixelWand and a pixel round trip, ``draw_image`` of a
    DrawingWand, a WandView update, a PixelIterator sync, the top-level
    ``read``/``write``, and a clone whose writes leave the original
    alone, each against the CPU wand.  Every launch count is set to 0
    just before the calls it counts."""
    import tempfile

    import imagemagick_tpu_torch as imt
    from imagemagick_tpu_torch.core.image import Image as TImage
    from imagemagick_tpu_torch.core.spec import ImageSpec as TSpec
    from imagemagick_tpu_torch.wand import api as wa

    rng = np.random.default_rng(seed + 26)
    counts = {"k1": 0, "k3": 0, "k4": 0, "walk_fs": 0}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        frame = _smooth_u8(rng, 1, IO_H, IO_W, C)[0]
        src = os.path.join(td, "in.ppm")
        with open(src, "wb") as f:
            f.write(f"P6\n{IO_W} {IO_H}\n255\n".encode() + frame.tobytes())

        def chain(device, out):
            w = wa.new_magick_wand(device=device)
            w.read_image(src)
            w.resize_image(960, 540)
            w.gaussian_blur_image(0.0, 2.0)
            w.write_image(out)
            return w

        chain(dev, os.path.join(td, "warm.ppm"))
        torch.cuda.synchronize()
        reset_launches()
        card = chain(dev, os.path.join(td, "card.ppm"))
        torch.cuda.synchronize()
        la = launched()
        require(la["k1"] == 2 and la["k3"] == 0,
                f"wand chain launches {la}")
        counts["k1"] += la["k1"]
        require(card.current.data.is_cuda and
                tuple(card.current.data.shape) == (540, 960, C),
                f"wand chain {card.current}")
        require(bool(torch.isfinite(card.current.data).all()),
                "wand chain: non-finite pixels")
        t1 = time.perf_counter()
        cpu = chain("cpu", os.path.join(td, "cpu.ppm"))
        cpu_s = time.perf_counter() - t1
        err = max_err(card.current.data.cpu(), cpu.current.data)
        a = np.asarray(imt.read(os.path.join(td, "card.ppm"),
                                device="cpu").to_uint16())
        b = np.asarray(imt.read(os.path.join(td, "cpu.ppm"),
                                device="cpu").to_uint16())
        apart = float(np.mean(np.abs(a.astype(np.int64) - b) > 1))
        require(err <= K1_TOL and apart == 0.0,
                f"wand chain vs the CPU wand: {err}, {apart} apart")
        runs = [_once_ms(lambda: chain(dev, os.path.join(td, "t.ppm")))
                for _ in range(WAND_RUNS)]
        print(f"wand chain read_image {IO_H}x{IO_W}x{C} PPM -> resize_image"
              f"(960, 540) -> gaussian_blur_image(0, 2) -> write_image "
              f"16-bit PPM: launches {la}; max|d| vs the CPU wand "
              f"{err:.3e} (tolerance {K1_TOL}), 16-bit samples more than one "
              f"level apart {apart:.2e}; {statistics.median(runs):.2f} ms a "
              f"chain (median of {WAND_RUNS}, host decode and encode "
              f"included), the CPU wand {cpu_s * 1e3:.0f} ms [{name_limit}]")

        # K3: a non-opaque alpha declines the fused offer
        xa = torch.rand(540, 960, 4, generator=gen, device=dev)
        xa[..., 3] = 0.25 + 0.5 * xa[..., 3]
        wk = wa.MagickWand(dev)
        wk.add_image(TImage(xa, TSpec(alpha=True)))
        wc = wa.MagickWand("cpu")
        wc.add_image(TImage(xa.cpu(), TSpec(alpha=True)))
        reset_launches()
        wk.blur_image(0.0, 2.0)
        torch.cuda.synchronize()
        la3 = launched()
        require(la3["k3"] >= 1 and la3["k1"] == 0,
                f"wand blur_image with alpha launches {la3}")
        counts["k3"] += la3["k3"]
        wc.blur_image(0.0, 2.0)
        err3 = max_err(wk.current.data.cpu(), wc.current.data)
        require(err3 <= K3_TOL, f"wand blur_image with alpha: {err3}")

        # K4: Otsu over a page
        page = torch.from_numpy(_page_u8(rng)[..., None].astype(np.float32)
                                / np.float32(255.0))
        wk = wa.MagickWand(dev)
        wk.add_image(TImage(page.to(dev)))
        wc = wa.MagickWand("cpu")
        wc.add_image(TImage(page))
        reset_launches()
        wk.auto_threshold_image("otsu")
        torch.cuda.synchronize()
        la4 = launched()
        require(la4["k4"] == 1, f"wand auto_threshold_image launches {la4}")
        counts["k4"] += la4["k4"]
        wc.auto_threshold_image("otsu")
        require(torch.equal(wk.current.data.cpu(), wc.current.data),
                "wand auto_threshold_image vs the CPU wand")
        # the palette walk: remap_image of a batch under a dither
        frames = torch.rand(2, 96, 128, C, generator=gen, device=dev)
        pal = torch.rand(4, 4, C, generator=gen, device=dev)   # 16 entries
        wk, pk = wa.MagickWand(dev), wa.MagickWand(dev)
        wk.add_image(TImage(frames))
        pk.add_image(TImage(pal))
        wc, pc = wa.MagickWand("cpu"), wa.MagickWand("cpu")
        wc.add_image(TImage(frames.cpu()))
        pc.add_image(TImage(pal.cpu()))
        reset_launches()
        wk.remap_image(pk, True)
        torch.cuda.synchronize()
        law = launched()
        require(law["walk_fs"] == 1, f"wand remap_image launches {law}")
        counts["walk_fs"] = law["walk_fs"]
        wc.remap_image(pc, True)
        require(torch.equal(wk.current.data.cpu(), wc.current.data),
                "wand remap_image under a dither vs the CPU wand")
        print(f"wand remap_image of 2x96x128x{C} onto 16 entries under a "
              f"dither: launches {law}, equal to the CPU wand")
        print(f"wand blur_image(0, 2) of 540x960x4 with a non-opaque alpha: "
              f"launches {la3}, max|d| vs the CPU wand {err3:.3e} (tolerance "
              f"{K3_TOL}); auto_threshold_image(otsu) of a {H3}x{W3} page: "
              f"launches {la4}, equal to the CPU wand")

        # pixels, drawing, views and iterators, clones, top-level IO
        sides = {}
        for key, where in (("card", dev), ("host", "cpu")):
            w = wa.new_magick_wand(device=where)
            w.read_image(src)
            keep = w.current.data.clone()
            c = w.clone()
            px = c.get_image_pixel_color(10, 20)
            px.red, px.blue = 1.0, 0.25
            c.set_image_pixel_color(10, 20, px)
            d = wa.DrawingWand()
            d.set_fill_color(wa.PixelWand("srgba(255,200,0,0.5)"))
            d.set_stroke_color("navy")
            d.set_stroke_width(3)
            d.rectangle(100, 80, 700, 500)
            d.circle(1200, 600, 1400, 600)
            c.draw_image(d)
            wa.WandView(c, 300, 200, 640, 360).update(lambda r: 1.0 - r)
            it = wa.PixelIterator(c, 0, 700, 64, 4)
            for row in it:
                for p in row:
                    p.green = 0.5
                it.sync_iterator()
            require(torch.equal(w.current.data, keep),
                    f"wand clone's writes reached the original on {where}")
            out = os.path.join(td, f"io-{key}.ppm")
            imt.write(c.current, out)
            back = imt.read(out, device=where)
            require(back.data.device.type == torch.device(where).type,
                    f"read lands on {back.data.device}")
            sides[key] = (c.current.data.cpu(),
                          back.data.cpu(),
                          c.get_image_pixel_color(10, 20).get_color())
        (dc, bc, pc), (dh, bh, ph) = sides["card"], sides["host"]
        err_io = max_err(dc, dh)
        require(err_io <= DRAW_TOL and torch.equal(bc, bh) and pc == ph,
                f"wand pixels/draw/view/iterator vs the CPU wand: {err_io}")
        print(f"wand pixel round trip, draw_image, WandView.update, "
              f"PixelIterator sync, clone isolation and read/write on the "
              f"card: max|d| vs the CPU wand {err_io:.3e} (tolerance "
              f"{DRAW_TOL}), files equal")
    print(f"wand phase: {time.perf_counter() - t0:.1f} s, launches {counts}")
    return counts


def _keys(stdout: str) -> dict:
    return dict(ln.split("=", 1) for ln in stdout.splitlines() if "=" in ln)


def _wall(cmd, cwd, env, label: str, name_limit: str, note: str = ""):
    """Run ``cmd`` to its end (at most 300 s); its wall is printed, and a
    nonzero exit fails the phase with its error text."""
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       cwd=cwd, env=env)
    wall = time.perf_counter() - t0
    print(f"magickpp_perl {label}: exit {r.returncode}, wall {wall:.2f} s"
          f"{note} [{name_limit}]")
    require(r.returncode == 0, f"{label} failed:\n{r.stdout}\n{r.stderr}")
    return r


def _f32(path: str, h: int, w: int) -> torch.Tensor:
    return torch.from_numpy(np.fromfile(path, np.float32).reshape(h, w, 4))


def _u16_ppm(path: str) -> np.ndarray:
    import imagemagick_tpu_torch as imt

    return np.asarray(imt.read(path, device="cpu").to_uint16()).astype(
        np.int64)


def magickpp_perl_phase(dev, gen, name_limit: str, seed: int) -> dict:
    """magickpp_perl: the Magick++ layer and PerlMagick on the card (the
    module docstring says what it runs).  The C++ programs count their
    own launches in their embedded interpreters; the Perl chain's
    requests are counted by ``rpc_server.serve`` in this process."""
    import ast
    import io as _io
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image as PILImage

    from imagemagick_tpu_torch.native.magickpp import build as mpp
    from imagemagick_tpu_torch.wand import rpc_server

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep +
               os.environ.get("PYTHONPATH", ""), IMTPU_PYTHON=sys.executable)
    rng = np.random.default_rng(seed + 27)
    counts = {"k1": 0, "k3": 0, "k4": 0}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        frame = _smooth_u8(rng, 1, IO_H, IO_W, C)[0]
        src = os.path.join(td, "frame.ppm")
        with open(src, "wb") as f:
            f.write(f"P6\n{IO_W} {IO_H}\n255\n".encode() + frame.tobytes())
        ah, aw = MPP_ALPHA
        rgba = _smooth_u8(rng, 1, ah, aw, 4)[0]
        rgba[..., 3] = 64 + rgba[..., 3] // 2          # alpha 0.25-0.75
        rgba_path = os.path.join(td, "alpha.png")
        PILImage.fromarray(rgba, "RGBA").save(rgba_path)
        page_path = os.path.join(td, "page.pgm")
        with open(page_path, "wb") as f:
            f.write(f"P5\n{W3} {H3}\n255\n".encode() +
                    _page_u8(rng).tobytes())
        chain_src = os.path.join(td, "chain.cpp")
        with open(chain_src, "w") as f:
            f.write(MAGICKPP_CHAIN)
        demo = os.path.join(root, "tests", "magickpp_demo.cpp")

        # the library, then the four programs at once
        tb = time.perf_counter()
        mpp.build()
        exe = {key: os.path.join(td, key) for key in
               ("demo_card", "demo_cpu", "chain_card", "chain_cpu")}
        jobs = [(demo, exe["demo_card"], None), (demo, exe["demo_cpu"], "cpu"),
                (chain_src, exe["chain_card"], None),
                (chain_src, exe["chain_cpu"], "cpu")]
        with ThreadPoolExecutor(len(jobs)) as pool:
            for fut in [pool.submit(mpp.compile_program, *j) for j in jobs]:
                fut.result()
        print(f"magickpp_perl build: the library and 4 programs "
              f"{time.perf_counter() - tb:.2f} s (g++)")

        # the runs that are not timed on the card, at once: the demo on
        # the card and on the CPU, the C++ and the Perl chain on the CPU;
        # then the card's two chains alone, timed
        script = os.path.join(td, "chain.pl")
        with open(script, "w") as f:
            f.write(PERL_CHAIN)
        lib = os.path.join(root, "imagemagick_tpu_torch", "bindings", "perl")
        perl_out = {where: os.path.join(td, f"perl-{where}.ppm")
                    for where in ("cuda", "cpu")}
        dirs = {}
        for key in exe:
            dirs[key] = os.path.join(td, key + "_out")
            os.mkdir(dirs[key])

        def chain_cmd(key):
            return [exe[key], src, rgba_path, page_path, dirs[key],
                    str(MPP_RUNS)]

        def perl_cmd(where):
            return ["perl", f"-I{lib}", script, where, src, perl_out[where],
                    str(MPP_RUNS)]

        untimed = {"demo_card": ([exe["demo_card"], dirs["demo_card"]],
                                 dirs["demo_card"]),
                   "demo_cpu": ([exe["demo_cpu"], dirs["demo_cpu"]],
                                dirs["demo_cpu"]),
                   "chain_cpu": (chain_cmd("chain_cpu"), dirs["chain_cpu"]),
                   "perl_cpu": (perl_cmd("cpu"), td)}
        # two host threads each, so that the four share the host's cores
        env2 = dict(env, OMP_NUM_THREADS="2")
        with ThreadPoolExecutor(len(untimed)) as pool:
            futs = {key: pool.submit(_wall, cmd, cwd, env2, key, name_limit,
                                     " (beside the other untimed runs, two "
                                     "host threads each)")
                    for key, (cmd, cwd) in untimed.items()}
            runs = {key: _keys(fut.result().stdout)
                    for key, fut in futs.items()}
        require(len(runs["demo_cpu"]) == 80 and
                runs["demo_card"] == runs["demo_cpu"],
                f"magickpp demo keys differ: {runs}")
        print("magickpp demo: the card's 80 key=value lines equal the CPU "
              "build's")
        kh, dh = runs["chain_cpu"], dirs["chain_cpu"]
        dc = dirs["chain_card"]
        kc = _keys(_wall(chain_cmd("chain_card"), dc, env, "chain_card",
                         name_limit).stdout)
        la = {k: ast.literal_eval(kc[f"launches_{k}"])
              for k in ("chain", "alpha", "otsu")}
        require(la["chain"]["k1"] == 2 and la["chain"]["k3"] == 0,
                f"Magick++ chain launches {la['chain']}")
        require(la["alpha"]["k3"] >= 1 and la["alpha"]["k1"] == 0,
                f"Magick++ blur with alpha launches {la['alpha']}")
        require(la["otsu"]["k4"] == 1, f"Magick++ Otsu launches {la['otsu']}")
        counts["k1"] += la["chain"]["k1"]
        counts["k3"] += la["alpha"]["k3"]
        counts["k4"] += la["otsu"]["k4"]
        require(kc["chain_shape"] == kh["chain_shape"] == "960x540",
                f"Magick++ chain shape {kc['chain_shape']}")
        got, want = (_f32(os.path.join(x, "chain.f32"), 540, 960)
                     for x in (dc, dh))
        err = max_err(got, want)
        require(bool(torch.isfinite(got).all()), "Magick++ chain non-finite")
        apart = float(np.mean(np.abs(
            _u16_ppm(os.path.join(dc, "chain16.ppm")) -
            _u16_ppm(os.path.join(dh, "chain16.ppm"))) > 1))
        require(err <= K1_TOL and apart == 0.0,
                f"Magick++ chain vs the CPU build: {err}, {apart} apart")
        err3 = max_err(*(_f32(os.path.join(x, "alpha.f32"), ah, aw)
                         for x in (dc, dh)))
        require(err3 <= K3_TOL, f"Magick++ blur with alpha: {err3}")
        require(torch.equal(*(_f32(os.path.join(x, "otsu.f32"), H3, W3)
                              for x in (dc, dh))),
                "Magick++ Otsu vs the CPU build")
        print(f"magickpp chain Image({IO_H}x{IO_W}x{C} PPM) -> resize(960x540)"
              f" -> gaussianBlur(0, 2) -> write 16-bit PPM: launches "
              f"{la['chain']}, {kc['chain_ms']} ms a chain on the card "
              f"(median of {MPP_RUNS}, host decode and encode included; the "
              f"CPU build {kh['chain_ms']} ms on two threads beside the "
              f"untimed runs); "
              f"max|d| vs the CPU build "
              f"{err:.3e} (tolerance {K1_TOL}), 16-bit samples more than one "
              f"level apart {apart:.2e}; blur(0, 2) of {ah}x{aw}x4 with a "
              f"non-opaque alpha: launches {la['alpha']}, max|d| {err3:.3e} "
              f"(tolerance {K3_TOL}); autoThreshold(Otsu) of a {H3}x{W3} "
              f"page: launches {la['otsu']}, equal [{name_limit}]")

        # PerlMagick: the script on the card (the CPU run is done)
        perl_ms = {"cpu": runs["perl_cpu"]["perl_chain_ms"],
                   "cuda": _keys(_wall(perl_cmd("cuda"), td, env,
                                       "perl_cuda", name_limit).stdout)[
                                           "perl_chain_ms"]}
        apart_pl = float(np.mean(np.abs(
            _u16_ppm(os.path.join(td, "perl-cuda.ppm")) -
            _u16_ppm(os.path.join(td, "perl-cpu.ppm"))) > 1))
        require(apart_pl == 0.0, f"Perl chain vs the CPU: {apart_pl} apart")
        # the same requests as the Perl module sends, served here on the
        # card with the launch counts around them
        served = os.path.join(td, "served.ppm")
        reqs = [{"id": 1, "op": "new"},
                {"id": 2, "op": "pm", "wand": 1, "method": "Read",
                 "kwargs": {"filename": src}},
                {"id": 3, "op": "pm", "wand": 1, "method": "Resize",
                 "kwargs": {"geometry": "960x540"}},
                {"id": 4, "op": "pm", "wand": 1, "method": "Blur",
                 "kwargs": {"radius": 0, "sigma": 2}},
                {"id": 5, "op": "pm", "wand": 1, "method": "Write",
                 "kwargs": {"filename": served}},
                {"id": 6, "op": "quit"}]
        replies = _io.StringIO()
        torch.cuda.synchronize()
        reset_launches()
        rpc_server.serve(_io.StringIO("".join(json.dumps(q) + "\n"
                                              for q in reqs)),
                         replies, device=dev)
        torch.cuda.synchronize()
        lp = launched()
        got = [json.loads(ln) for ln in replies.getvalue().splitlines()]
        require(all("error" not in g for g in got) and len(got) == 6,
                f"rpc_server replies {got}")
        require(lp["k1"] == 2 and lp["k3"] == 0,
                f"rpc_server chain launches {lp}")
        counts["k1"] += lp["k1"]
        with open(served, "rb") as a, \
                open(os.path.join(td, "perl-cuda.ppm"), "rb") as b:
            require(a.read() == b.read(),
                    "the served requests wrote another file than Perl")
        print(f"perl chain Read({IO_H}x{IO_W}x{C} PPM) -> Resize(960x540) -> "
              f"Blur(0, 2) -> Write 16-bit PPM through Image::Magick: "
              f"{perl_ms['cuda']} ms a chain on the card (median of "
              f"{MPP_RUNS}, host decode, encode and the pipe included; on "
              f"the CPU {perl_ms['cpu']} ms on two threads beside the "
              f"untimed runs); 16-bit "
              f"samples more than one "
              f"level apart from the CPU run {apart_pl:.2e}; its requests "
              f"served in this process: launches {lp}, the same file "
              f"[{name_limit}]")
    print(f"magickpp_perl phase: {time.perf_counter() - t0:.1f} s, launches "
          f"{counts}")
    return counts


def _giga_region(sa, y0: int, y1: int, x0: int, x1: int) -> torch.Tensor:
    """Rows y0:y1 and columns x0:x1 of image 0 of a ShardedArray split
    over sy and sx, read from its blocks."""
    _, bh, bw, _ = sa.blocks[0, 0, 0].shape
    rows = []
    for iy in range(sa.blocks.shape[1]):
        a, b = max(y0, iy * bh), min(y1, (iy + 1) * bh)
        if a >= b:
            continue
        cols = []
        for ix in range(sa.blocks.shape[2]):
            c, d = max(x0, ix * bw), min(x1, (ix + 1) * bw)
            if c < d:
                cols.append(sa.blocks[0, iy, ix][0, a - iy * bh:b - iy * bh,
                                                 c - ix * bw:d - ix * bw])
        rows.append(torch.cat(cols, 1))
    return torch.cat(rows, 0)


def _giga_band_err(img: torch.Tensor, out, taps, y0: int, y1: int, x0: int,
                   x1: int) -> float:
    """The largest difference between the sharded pipeline's output over
    rows y0:y1, columns x0:x1 and the unsharded math (K3's plain version,
    ``_separable_blur_plain``, then the unsharp) on that band's input
    with a halo of the blur's radius (cut at the image's border, where
    the edge pad is the global one)."""
    from imagemagick_tpu_torch.ops.gpu_kernels import _separable_blur_plain

    r = (len(taps) - 1) // 2
    hgt, wid = img.shape[0], img.shape[1]
    a, b = max(0, y0 - r), min(hgt, y1 + r)
    c, d = max(0, x0 - r), min(wid, x1 + r)
    blur = _separable_blur_plain(img[a:b, c:d][None].contiguous(),
                                 taps)[0][y0 - a:y1 - a, x0 - c:x1 - c]
    x = img[y0:y1, x0:x1]
    want = torch.sub(x, blur).mul_(1.0).add_(x).clamp_(0.0, 1.0)
    return max_err(_giga_region(out, y0, y1, x0, x1), want)


def parallel_phase(dev, name_limit: str, seed: int) -> dict:
    """parallel: ``parallel/`` (mesh, halo exchange, sharded ops),
    ``models/gigapixel.py``, the CLI's ``-define tpu:mesh`` and the dry
    run, on one card named several times in each mesh (every exchange
    and reduction runs on it).  (1) Config #2's batch (8 x 1080x1920x3)
    on ``make_mesh(2, 2, 2, devices=[cuda:0] * 8)``: blur sigma 2 (K3 on
    each of the 8 blocks), histograms of 256 (K4 on each block) and 64
    bins, the statistics, a Lanczos resize to 540x960, open square:1,
    median r 1 and Otsu on the gray batch (K4 on each block), each held
    to the port's unsharded op on the card (resize within PAR_TOL, the
    rest equal; the statistics to float64 within 1e-5 and 1e-4); the
    blur to K3's plain version within PAR_TOL, the 256-bin histogram and
    Otsu's thresholds to K4's plain version, exactly.  (2) K1 on each block of a dp = 4 mesh: config #1's batch,
    held to one unsharded ``fused_resize_pipeline`` call within
    K1_DP_TOL.  (3) ``process_gigapixel`` of one GIGA x GIGA x 3 image
    from a seeded card generator, sigma GIGA_SIGMA, on a 1x2x2 mesh (K3
    once a block): bands GIGA_BAND wide across each seam and along each
    border held to K3's plain version and the unsharp within PAR_TOL, the
    statistics to
    float64 sums taken band by band; its time (median of GIGA_RUNS), MP/s
    and peak card memory.  (4) The CLI: ``-define tpu:mesh=1x1 -define
    tpu:shard-threshold=1024 -gaussian-blur 0x2 -auto-threshold otsu`` on
    a PNG writes the bytes of the run without the defines and counts one
    ``sharded`` run; ``tpu:mesh=2x2`` fails as the JAX CLI fails on one
    device.  (5) An NCCL group of one (``init_distributed``): the
    statistics and a histogram through its ``all_reduce`` equal the
    results without the group; the group is destroyed.  (6)
    ``dryrun_multichip(8)``, whose default devices name the card eight
    times.  Every launch count is
    set to 0 just before each main-path call and read just after; the
    comparisons' launches are not counted."""
    import socket
    import tempfile

    import torch.distributed as dist
    from PIL import Image as PImage

    from imagemagick_tpu_torch.models import gigapixel as gp
    from imagemagick_tpu_torch.ops import blur as bl
    from imagemagick_tpu_torch.ops import dispatch
    from imagemagick_tpu_torch.ops import fused_pipeline as fp
    from imagemagick_tpu_torch.ops import gpu_kernels as gk
    from imagemagick_tpu_torch.ops import morphology as mo
    from imagemagick_tpu_torch.ops import resize as rz
    from imagemagick_tpu_torch.ops import statistic as stx
    from imagemagick_tpu_torch.ops import threshold as th
    from imagemagick_tpu_torch.ops.enhance import grayscale
    from imagemagick_tpu_torch.parallel import mesh as pm
    from imagemagick_tpu_torch.parallel import spatial as sp
    from imagemagick_tpu_torch.parallel.dryrun import dryrun_multichip

    gen = torch.Generator(device=dev).manual_seed(seed + 28)
    counts = {"k1": 0, "k3": 0, "k4": 0}
    t0 = time.perf_counter()

    def main_path(fn):
        """fn() with every launch count set to 0 just before it and read
        just after; its K1, K3 and K4 launches join ``counts``."""
        for key in gk.LAUNCHES:
            gk.LAUNCHES[key] = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: gk.LAUNCHES[k] for k in counts}
        for k in counts:
            counts[k] += got[k]
        return out, got

    # -- (1) the spatial ops on config #2's batch --------------------------
    mesh8 = pm.make_mesh(2, 2, 2, devices=[dev] * 8)
    batch = torch.rand((N2, H2, W2, C), generator=gen, device=dev)
    xs = pm.device_put(batch, pm.batch_sharding(mesh8))
    taps = bl.gaussian_kernel_1d(0.0, SIGMA)
    out, ln = main_path(lambda: sp.sharded_gaussian_blur(mesh8, SIGMA)(xs))
    require(ln["k3"] == 8 and out.shape == batch.shape,
            f"sharded blur launches {ln}")
    err = max_err(out.gather(), gk._separable_blur_plain(batch, taps))
    require(err <= PAR_TOL, f"sharded blur max|d| {err}")
    blur_ms, unsharded_ms = median_ms(
        lambda: sp.sharded_gaussian_blur(mesh8, SIGMA)(xs),
        lambda: bl._separable_conv(batch, taps, "edge"), runs=PAR_RUNS)
    print(f"parallel: sharded blur sigma {SIGMA} on 2x2x2 blocks of "
          f"{tuple(xs.blocks[0, 0, 0].shape)}: max|d| {err:.3e} vs K3's "
          f"plain version ({len(taps)} taps), launches {ln}; {blur_ms:.4f} ms against "
          f"{unsharded_ms:.4f} ms unsharded [{name_limit}]")

    hist, ln = main_path(lambda: sp.sharded_histogram(mesh8, 256)(xs))
    want = gk.histogram256_plain(batch.reshape(-1, W2 * C)).to(
        torch.int64).sum(0)
    require(ln["k4"] == 8 and torch.equal(hist.to(torch.int64), want),
            f"sharded histogram 256: launches {ln}")
    hist64, _ = main_path(lambda: sp.sharded_histogram(mesh8, 64)(xs))
    a = batch.cpu().numpy()
    idx = np.clip((a * np.float32(63) + np.float32(0.5)).astype(np.int32),
                  0, 63)
    require(np.array_equal(hist64.cpu().numpy().astype(np.int64),
                           np.bincount(idx.ravel(), minlength=64)),
            "sharded histogram 64 against numpy")
    (mean, std, mn, mx), _ = main_path(lambda: sp.sharded_statistics(mesh8)(xs))
    b64 = batch.to(torch.float64)
    err_mean = max_err(mean.double(), b64.mean((0, 1, 2)))
    err_std = max_err(std.double(), b64.std((0, 1, 2), unbiased=False))
    del b64
    require(err_mean <= 1e-5 and err_std <= 1e-4 and
            torch.equal(mn, batch.amin((0, 1, 2))) and
            torch.equal(mx, batch.amax((0, 1, 2))),
            f"sharded statistics {err_mean} {err_std}")
    rsz, _ = main_path(lambda: sp.sharded_resize(
        mesh8, (H2, W2), (H2 // 2, W2 // 2), "lanczos")(xs))
    err_rz = max_err(rsz.gather(), rz.resize(batch, H2 // 2, W2 // 2,
                                             "lanczos"))
    require(err_rz <= PAR_TOL, f"sharded resize max|d| {err_rz}")
    opened, _ = main_path(lambda: sp.sharded_morphology(
        mesh8, "open", "square:1")(xs))
    require(torch.equal(opened.gather(),
                        mo.morphology(batch, "open", "square:1")),
            "sharded open")
    med, _ = main_path(lambda: sp.sharded_median(mesh8, 1)(xs))
    require(torch.equal(med.gather(), stx.median_filter(batch, 1)),
            "sharded median")
    gray = grayscale(batch)
    otsu, ln = main_path(lambda: sp.sharded_otsu_threshold(mesh8)(gray))
    inten = gray[..., 0:1]
    plain_t = th._otsu(gk.histogram256_plain(inten.reshape(
        N2 * H2, W2)).to(torch.int64).reshape(N2, H2, 256).sum(1))
    require(ln["k4"] == 8 and torch.equal(otsu.gather(),
                                          th.auto_threshold(gray, "otsu"))
            and torch.equal(otsu.gather(), (inten > plain_t.reshape(
                -1, 1, 1, 1)).to(gray.dtype)),
            f"sharded otsu: launches {ln}")
    del inten
    print(f"parallel: histograms 256 (K4 x 8, against its plain version) "
          f"and 64 (against numpy) equal; statistics "
          f"mean {err_mean:.3e} std {err_std:.3e} vs float64, min/max "
          f"equal; lanczos to {H2 // 2}x{W2 // 2} max|d| {err_rz:.3e}; open "
          f"square:1, median r 1 and Otsu (K4 x 8) on the gray batch equal "
          f"to the unsharded ops (Otsu also to its plain-K4 thresholds)")
    del xs, out, rsz, opened, med, gray, otsu

    # -- (2) K1 on each block of a dp = 4 mesh ------------------------------
    mesh4 = pm.make_mesh(4, 1, 1, devices=[dev] * 4)
    b1 = torch.rand((N, H, W, C), generator=gen, device=dev)

    def k1_block(b):
        return fp.fused_resize_pipeline(b, HOUT, WOUT, "lanczos", SIGMA, GRAY)

    k1out, ln = main_path(lambda: sp.halo_map(k1_block, mesh4, 0, 0)(b1))
    require(ln["k1"] == 4, f"K1 over dp launches {ln}")
    err_k1 = max_err(k1out.gather(), k1_block(b1))
    require(err_k1 <= K1_DP_TOL, f"K1 over dp max|d| {err_k1}")
    print(f"parallel: K1 on each of 4 dp blocks of {(N, H, W, C)}: "
          f"launches {ln}, max|d| {err_k1:.3e} vs one unsharded call")
    del b1, k1out

    # -- (3) the gigapixel --------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    img = torch.rand((GIGA, GIGA, C), generator=gen, device=dev)
    gmesh = pm.make_mesh(1, 2, 2, devices=[dev] * 4)

    def giga():
        return gp.process_gigapixel(img, mesh=gmesh, sigma=GIGA_SIGMA)

    (gout, gstats), ln = main_path(giga)
    require(ln["k3"] == 4 and gout.shape == (1, GIGA, GIGA, C),
            f"gigapixel launches {ln}, shape {gout.shape}")
    del gout
    times, pipe_ms, stat_ms = [], [], []
    for _ in range(GIGA_RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        gout, gstats = giga()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        del gout
        t = time.perf_counter()
        gout = gp.sharded_pipeline(gmesh, GIGA_SIGMA)(img[None])
        torch.cuda.synchronize()
        pipe_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        gp.sharded_global_stats(gmesh)(gout)
        torch.cuda.synchronize()
        stat_ms.append((time.perf_counter() - t) * 1e3)
        if len(times) < GIGA_RUNS:
            del gout
    peak = torch.cuda.max_memory_allocated(dev)
    g_ms = statistics.median(times)
    mpix = GIGA * GIGA / 1e6
    gtaps = bl.gaussian_kernel_1d(0.0, GIGA_SIGMA)
    half, band = GIGA // 2, GIGA_BAND
    seam = 0.0
    for y0 in (0, half - band // 2, GIGA - band):
        seam = max(seam, _giga_band_err(img, gout, gtaps, y0, y0 + band, 0,
                                        GIGA))
    for x0 in (0, half - band // 2, GIGA - band):
        seam = max(seam, _giga_band_err(img, gout, gtaps, 0, GIGA, x0,
                                        x0 + band))
    require(seam <= PAR_TOL, f"gigapixel seams max|d| {seam}")
    s = torch.zeros(C, dtype=torch.float64, device=dev)
    s2 = torch.zeros(C, dtype=torch.float64, device=dev)
    gmn = torch.full((C,), 2.0, device=dev)
    gmx = torch.full((C,), -1.0, device=dev)
    for y0 in range(0, GIGA, 1024):
        rows = _giga_region(gout, y0, y0 + 1024, 0, GIGA)
        r64 = rows.to(torch.float64)
        s += r64.sum((0, 1))
        s2 += (r64 * r64).sum((0, 1))
        gmn = torch.minimum(gmn, rows.amin((0, 1)))
        gmx = torch.maximum(gmx, rows.amax((0, 1)))
    n = float(GIGA * GIGA)
    m64 = s / n
    sd64 = torch.sqrt(s2 / n - m64 * m64)
    err_gm = float(np.abs(gstats["mean"] - m64.cpu().numpy()).max())
    err_gs = float(np.abs(gstats["std"] - sd64.cpu().numpy()).max())
    require(err_gm <= 1e-5 and err_gs <= 1e-4 and
            np.array_equal(gstats["min"], gmn.cpu().numpy()) and
            np.array_equal(gstats["max"], gmx.cpu().numpy()),
            f"gigapixel statistics {err_gm} {err_gs}")
    g_bound = bound(3 * 4 * img.numel(), 2 * 2 * len(gtaps) * img.numel())
    print(f"parallel: gigapixel {GIGA}x{GIGA}x{C} float32 on a 1x2x2 mesh, "
          f"sigma {GIGA_SIGMA} ({len(gtaps)} taps), launches {ln}: "
          f"process_gigapixel {g_ms:.1f} ms = {mpix / g_ms * 1e3:.1f} MP/s "
          f"(median of {GIGA_RUNS}: {[round(t, 1) for t in times]}), "
          f"pipeline {statistics.median(pipe_ms):.1f} ms, statistics "
          f"{statistics.median(stat_ms):.1f} ms, bound {g_bound[0]:.2f} ms "
          f"({g_bound[1]}: the input read twice, the output once); peak "
          f"card memory {peak / 2 ** 30:.2f} GiB; seams and borders max|d| "
          f"{seam:.3e}; statistics mean {err_gm:.3e} std {err_gs:.3e} vs "
          f"float64 bands, min/max equal [{name_limit}]")
    del img, gout
    torch.cuda.empty_cache()

    # -- (4) the CLI's -define tpu:mesh -------------------------------------
    rng = np.random.default_rng(seed + 28)
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "in.png")
        PImage.fromarray(_smooth_u8(rng, 1, IO_H, IO_W, C)[0]).save(src)
        chain = ["-gaussian-blur", "0x2", "-auto-threshold", "otsu"]
        plain, sharded = os.path.join(td, "plain.png"), \
            os.path.join(td, "sharded.png")
        rc, _, err = _run_main([src] + chain + [plain], dev)
        require(rc == 0, f"CLI plain run: {err}")
        before = dispatch.COUNTS["sharded"]
        (rc, _, err), ln = main_path(lambda: _run_main(
            [src, "-define", "tpu:mesh=1x1", "-define",
             "tpu:shard-threshold=1024"] + chain + [sharded], dev))
        # the blur is the tagged prefix (one K1 launch, as in the JAX
        # CLI); the rest, Otsu, runs split over the mesh (K4)
        require(rc == 0 and dispatch.COUNTS["sharded"] == before + 1 and
                ln["k1"] == 1 and ln["k4"] == 1,
                f"CLI sharded run: rc {rc} launches {ln} {err}")
        with open(plain, "rb") as f1, open(sharded, "rb") as f2:
            require(f1.read() == f2.read(), "CLI sharded bytes")
        rc, _, err = _run_main([src, "-define", "tpu:mesh=2x2"] + chain +
                               [os.path.join(td, "x.png")], dev)
        need = f"mesh 1x2x2 needs 4 devices, have {torch.cuda.device_count()}"
        require(torch.cuda.device_count() >= 4 or
                (rc == 1 and need in err), f"tpu:mesh=2x2: rc {rc} {err}")
    print(f"parallel: CLI -define tpu:mesh=1x1 on {IO_H}x{IO_W}: one sharded "
          f"run, launches {ln}, the bytes of the run without it; "
          f"tpu:mesh=2x2: rc {rc}, {err.strip()}")

    # -- (5) an NCCL group of one -------------------------------------------
    mesh1 = pm.make_mesh(1, 2, 2, devices=[dev] * 4)
    x4 = pm.device_put(batch[:1], pm.batch_sharding(mesh1))
    alone = sp.sharded_statistics(mesh1)(x4)
    alone_h = sp.sharded_histogram(mesh8, 256)(batch)
    require(not mesh1.grouped and not mesh8.grouped, "meshes before the "
            "group")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    n_dev = pm.init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        require(n_dev == torch.cuda.device_count() and
                dist.get_backend() == "nccl", f"init_distributed {n_dev}")
        # meshes made under the group: their reductions all_reduce
        gmesh1 = pm.make_mesh(1, 2, 2, devices=[dev] * 4)
        gmesh8 = pm.make_mesh(2, 2, 2, devices=[dev] * 8)
        require(gmesh1.grouped and gmesh8.grouped, "meshes under the group")
        (grouped, grouped_h), _ = main_path(lambda: (
            sp.sharded_statistics(gmesh1)(batch[:1]),
            sp.sharded_histogram(gmesh8, 256)(batch)))
        require(all(torch.equal(a_, b_) for a_, b_ in zip(alone, grouped))
                and torch.equal(alone_h, grouped_h),
                "statistics through the NCCL all_reduce")
    finally:
        dist.destroy_process_group()
    print(f"parallel: NCCL group of one ({n_dev} device): "
          f"statistics and histogram through all_reduce equal the results "
          f"without the group; group destroyed")
    del batch, x4

    # -- (6) the dry run ----------------------------------------------------
    # its default devices: this process's cards in turn (cuda:0 x 8 here)
    _, ln = main_path(lambda: dryrun_multichip(8))
    print(f"parallel: dryrun_multichip(8) on its default devices "
          f"({torch.cuda.device_count()} card(s) named in turn), launches "
          f"{ln}")
    print(f"parallel phase: {time.perf_counter() - t0:.1f} s, launches "
          f"{counts}")
    return counts


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available() "
                         "is False); the port's kernels run only on one")
    from imagemagick_tpu_torch import Image, _build
    from imagemagick_tpu_torch.ops import dispatch
    from imagemagick_tpu_torch.ops import fused_pipeline as fp
    from imagemagick_tpu_torch.ops import gpu_kernels as gk
    from imagemagick_tpu_torch.ops.blur import (gaussian_kernel_1d,
                                                optimal_kernel_width_2d)

    t_start = time.perf_counter()
    name_limit = card()
    print(name_limit)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, ctypes)")

    # -- K3 against its plain version -------------------------------------
    taps15 = gauss_taps(optimal_kernel_width_2d(0.0, SIGMA), SIGMA)
    require(len(taps15) == 15, f"{len(taps15)} taps")
    k3_err = 0.0
    # config #1's shape; the generic kernel at C = 1, 2, 4 and 8 and at 3
    # and 33 taps; images smaller than the halo; W not a multiple of the
    # tile, with and without the 16-byte window copy (W * C % 4)
    for shape, taps in (((N, HOUT, WOUT, C), taps15),
                        ((3, 333, 517, 3), gauss_taps(33, 5.0)),
                        ((2, 64, 96, 1), gauss_taps(3, 0.8)),
                        ((2, 40, 70, 1), gauss_taps(33, 5.0)),
                        ((1, 45, 97, 2), gauss_taps(3, 0.8)),
                        ((1, 33, 65, 4), gauss_taps(33, 5.0)),
                        ((1, 37, 70, 8), gauss_taps(33, 5.0)),
                        ((2, 5, 7, 3), gauss_taps(33, 5.0)),
                        ((1, 6, 10, 3), taps15),
                        ((1, 70, 130, 3), taps15),
                        ((1, 100, 256, 3), gauss_taps(9, 1.5))):
        x = rand(*shape)
        err = max_err(gk.separable_blur(x, taps),
                      gk._separable_blur_plain(x, taps))
        torch.cuda.synchronize()
        print(f"k3 {shape} {len(taps)} taps: max|d| {err:.3e}")
        require(err <= K3_TOL, f"k3 max|d| {err}")
        k3_err = max(k3_err, err)

    # -- K1 against its plain version -------------------------------------
    batch = rand(N, H, W, C)
    flat = batch.reshape(N * H, W * C)         # the flat wire layout
    mix_key = tuple(map(tuple, GRAY.tolist()))
    WV, r0s, BAND, ntiles, GB, c0s, SPAN, OUT, OUTP = fp._plan(
        H, W, C, HOUT, WOUT, "lanczos", SIGMA, mix_key, 64)
    k1_ops = fp.plan_to_tensors(WV, GB, fp.flat_r0(r0s, N, H), dev)
    guids = tuple(range(len(c0s)))

    def k1_kernel():
        return fp.fused_kernel(flat, k1_ops, c0s, guids, ntiles)

    def k1_plain():
        return fp._fused_plain(flat, k1_ops, c0s, guids, ntiles)

    k1_err = max_err(k1_kernel(), k1_plain())
    torch.cuda.synchronize()
    print(f"k1 config #1 x {tuple(flat.shape)} WV {WV.shape} GB {GB.shape}: "
          f"max|d| {k1_err:.3e}")
    require(k1_err <= K1_TOL, f"k1 max|d| {k1_err}")

    odd = rand(1, 500, 750, C)
    got = dispatch.try_fused_batch_array(odd, TAGS)
    plain = dispatch.try_fused_batch_array(odd.cpu(), TAGS)
    torch.cuda.synchronize()
    require(got is not None and got.shape == (1, HOUT, WOUT, 1),
            "dispatch declined or misshaped")
    err = max_err(got.cpu(), plain)
    print(f"k1 dispatch 500x750: max|d| {err:.3e}")
    require(err <= K1_TOL, f"k1 dispatch max|d| {err}")
    k1_err = max(k1_err, err)
    ref_odd = fp.reference_pipeline_f64(odd.cpu().numpy(), HOUT, WOUT,
                                        "lanczos", SIGMA, GRAY)
    db = psnr(got.cpu().numpy(), ref_odd)
    print(f"dispatch 500x750 vs float64: {db:.2f} dB")
    require(db >= 100.0, f"dispatch {db} dB")

    # -- K1 at config #5's thumbnail shape ---------------------------------
    terms5, h8, wcp = thumbnail_terms(H, W)
    plan5 = thumbnail_plan(H, W)
    flat5 = rand(N5 * h8, wcp)
    k1_ops5 = fp.plan_to_tensors(plan5.WV, plan5.GB,
                                 fp.flat_r0(plan5.r0s, N5, h8), dev)

    def k1_kernel5():
        return fp.fused_kernel(flat5, k1_ops5, plan5.c0s, plan5.guids,
                               plan5.ntiles)

    def k1_plain5():
        return fp._fused_plain(flat5, k1_ops5, plan5.c0s, plan5.guids,
                               plan5.ntiles)

    def thumb_entry():
        return fp.fused_linear_pipeline(flat5, terms5, C,
                                        in_shape=(N5, h8, W, C),
                                        winc_pad=wcp)

    for key in gk.LAUNCHES:
        gk.LAUNCHES[key] = 0
    thumb = thumb_entry()
    torch.cuda.synchronize()
    launches5 = dict(gk.LAUNCHES)
    require(launches5["k1"] == 1, f"config #5 launches {launches5}")
    require(thumb.shape == (N5, THUMB, THUMB, C), f"shape {thumb.shape}")
    plain5 = k1_plain5()
    err = max_err(k1_kernel5(), plain5)
    torch.cuda.synchronize()
    print(f"k1 config #5 x {tuple(flat5.shape)} WV {plan5.WV.shape} GB "
          f"{plan5.GB.shape}: max|d| {err:.3e}; entry launches {launches5}")
    require(err <= K1_TOL, f"k1 config #5 max|d| {err}")
    k1_err = max(k1_err, err)
    TO5 = plan5.WV.shape[1]
    want = plain5.reshape(N5, plan5.ntiles * TO5, -1)[:, :THUMB, :plan5.OUT]
    err = max_err(thumb, want.reshape(N5, THUMB, THUMB, C))
    ref5 = fp.reference_pipeline_f64(
        flat5[:h8].reshape(1, h8, W, C).cpu().numpy(), THUMB, THUMB,
        "lanczos", 0.0)
    db5 = psnr(thumb[:1].cpu().numpy(), ref5)
    print(f"config #5 entry vs plain: max|d| {err:.3e}; image 0 vs float64: "
          f"{db5:.2f} dB")
    require(err <= K1_TOL and db5 >= 100.0, f"config #5 {err} {db5} dB")

    # -- the main path, end to end ----------------------------------------
    def fused_route():
        return fp.fused_resize_pipeline(flat, HOUT, WOUT, "lanczos", SIGMA,
                                        GRAY, in_shape=(N, H, W, C))

    def op_route():
        return Image(batch).resize(WOUT, HOUT, "lanczos") \
            .gaussian_blur(0.0, SIGMA).transform_colorspace("gray").data

    for key in gk.LAUNCHES:
        gk.LAUNCHES[key] = 0
    fused = fused_route()
    torch.cuda.synchronize()
    launches1f = dict(gk.LAUNCHES)
    ops = op_route()
    torch.cuda.synchronize()
    launches = dict(gk.LAUNCHES)
    print(f"config #1 main path launches: fused route {launches1f}, both "
          f"routes {launches}")
    require(launches1f["k1"] == 1 and launches["k3"] >= 1,
            f"launches {launches}")
    for out in (fused, ops):
        require(out.shape == (N, HOUT, WOUT, 1), f"shape {out.shape}")
        require(bool(torch.isfinite(out).all()), "non-finite output")
    ref = fp.reference_pipeline_f64(batch[:4].cpu().numpy(), HOUT, WOUT,
                                    "lanczos", SIGMA, GRAY)
    db_fused = psnr(fused[:4].cpu().numpy(), ref)
    db_routes = psnr(fused.cpu().numpy(), ops.cpu().numpy())
    print(f"fused route vs float64 (4 images): {db_fused:.2f} dB")
    print(f"fused route vs op route ({N} images): {db_routes:.2f} dB")
    require(db_fused >= 100.0, f"fused route {db_fused} dB")
    require(db_routes >= 60.0, f"routes agree at {db_routes} dB")

    # -- times --------------------------------------------------------------
    x3 = rand(N, HOUT, WOUT, C)
    k1_ms, k1_plain_ms = median_ms(k1_kernel, k1_plain)
    k3_ms, k3_plain_ms = median_ms(
        lambda: gk.separable_blur(x3, taps15),
        lambda: gk._separable_blur_plain(x3, taps15))
    k1_dev, k3_dev = device_ms(k1_kernel,
                               lambda: gk.separable_blur(x3, taps15))
    fused_ms, op_ms = median_ms(fused_route, op_route)
    mp = N * H * W / 1e6
    print(f"k1 config #1 (TO=64): kernel {k1_ms:.4f} ms ({k1_dev:.4f} "
          f"device-only), plain {k1_plain_ms:.4f} ms [{name_limit}]")
    print(f"k3 {(N, HOUT, WOUT, C)} 15 taps: kernel {k3_ms:.4f} ms "
          f"({k3_dev:.4f} device-only), plain {k3_plain_ms:.4f} ms "
          f"[{name_limit}]")
    k1_bytes = 4 * (flat.numel() + N * HOUT * WOUT + k1_ops.WV.numel() +
                    k1_ops.GB.numel())
    k1_bound = bound(k1_bytes, k1_flops(
        fp._axis_operator(H, HOUT, "lanczos", SIGMA),
        fp._axis_operator(W, WOUT, "lanczos", SIGMA), N, C, 1))
    k3_bound = bound(2 * 4 * x3.numel(), 2 * 2 * len(taps15) * x3.numel())
    print(f"k1 bound {k1_bound[0]:.4f} ms ({k1_bound[1]}), k3 bound "
          f"{k3_bound[0]:.4f} ms ({k3_bound[1]})")
    print(f"config #1 end to end: fused route {fused_ms:.4f} ms = "
          f"{mp / fused_ms * 1e3:.1f} MP/s, op route {op_ms:.4f} ms = "
          f"{mp / op_ms * 1e3:.1f} MP/s (input {mp:.3f} MP/step, median of "
          f"{RUNS}) [{name_limit}]")

    k1_ms5, k1_plain_ms5, thumb_ms = median_ms(k1_kernel5, k1_plain5,
                                                thumb_entry)
    k1_dev5, = device_ms(k1_kernel5)
    k1_bound5 = bound(
        4 * (flat5.numel() + N5 * THUMB * THUMB * C + k1_ops5.WV.numel() +
             k1_ops5.GB.numel()),
        k1_flops(*terms5[0], N5, C, C))
    print(f"k1 config #5 {(N5, h8, W, C)} -> {(THUMB, THUMB, C)}: kernel "
          f"{k1_ms5:.4f} ms ({k1_dev5:.4f} device-only), plain "
          f"{k1_plain_ms5:.4f} ms, bound {k1_bound5[0]:.4f} ms "
          f"({k1_bound5[1]}); fused_linear_pipeline (plans each call) "
          f"{thumb_ms:.4f} ms [{name_limit}]")

    # == config #5 end to end, config1_cli, config1_serve ===================
    # each main path with every launch count set to 0 just before it
    new5 = config5_end_to_end(args.seed, dev, gen, name_limit, k1_dev5)
    cli1 = cli_phase(dev, gen, name_limit)
    serve1 = serve_phase(args.seed, name_limit)
    tone = cli_tone_phase(dev, gen, name_limit)
    fx = effects_phase(dev, gen, name_limit)
    composite_phase(dev, gen, name_limit)
    clie = cli_effects_phase(dev, gen, name_limit)
    transform_phase(dev, gen, name_limit)
    distort_phase(dev, gen, name_limit)
    clid = cli_distort_phase(dev, gen, name_limit)
    cli_deskew_phase(dev, gen, name_limit)
    _timed("fx", lambda: fx_phase(dev, gen, name_limit))
    _timed("compare", lambda: compare_phase(dev, gen, name_limit))
    _timed("quantize", lambda: quantize_phase(dev, gen, name_limit))
    clich = _timed("cli_channel",
                   lambda: cli_channel_phase(dev, gen, name_limit))
    vis = _timed("vision", lambda: vision_phase(dev, gen, name_limit))
    _timed("draw", lambda: draw_phase(dev, gen, name_limit))
    cliv = _timed("cli_vision",
                  lambda: cli_vision_phase(dev, gen, name_limit))
    clidr = _timed("cli_draw", lambda: cli_draw_phase(dev, gen, name_limit))
    vfx = _timed("visual_effects",
                 lambda: visual_effects_phase(dev, gen, name_limit))
    _timed("layers", lambda: layers_phase(dev, gen, name_limit))
    clil = _timed("cli_layers",
                  lambda: cli_layers_phase(dev, gen, name_limit))
    _timed("io", lambda: io_phase(dev, gen, name_limit, args.seed))
    clif = _timed("cli_files", lambda: cli_files_phase(dev, gen, name_limit,
                                                       args.seed))
    srvc = _timed("serve_convert",
                  lambda: serve_convert_phase(dev, gen, name_limit,
                                              args.seed))
    coders = _timed("io_coders",
                    lambda: io_coders_phase(dev, gen, name_limit, args.seed))
    fmts = _timed("io_formats",
                  lambda: io_formats_phase(dev, gen, name_limit, args.seed))
    fmts4 = _timed("io_formats4",
                   lambda: io_formats4_phase(dev, gen, name_limit, args.seed))
    strm = _timed("io_stream",
                  lambda: io_stream_phase(dev, gen, name_limit, args.seed))
    tools = _timed("cli_tools",
                   lambda: cli_tools_phase(dev, gen, name_limit, args.seed))
    wand = wand_phase(dev, gen, name_limit, args.seed)
    mpp = magickpp_perl_phase(dev, gen, name_limit, args.seed)
    par = _timed("parallel", lambda: parallel_phase(dev, name_limit,
                                                    args.seed))
    k1_err = max(k1_err, new5["k1_err"])

    # == config #2: blur -> unsharp -> sRGB<->Lab ===========================
    batch2 = rand(N2, H2, W2, C)
    flat2 = batch2.reshape(N2 * H2, W2 * C)        # the flat wire layout
    blur2, unsharp2 = fp.blur_unsharp_taps(H2, W2, SIGMA, SIGMA_UNSHARP)
    require((len(blur2), len(unsharp2)) == (15, 9),
            f"{len(blur2)} blur, {len(unsharp2)} unsharp taps")

    # -- K3 at the config #2 op route's shapes -----------------------------
    for taps in (taps15, gaussian_kernel_1d(0.0, SIGMA_UNSHARP)):
        err = max_err(gk.separable_blur(batch2, taps),
                      gk._separable_blur_plain(batch2, taps))
        torch.cuda.synchronize()
        print(f"k3 {tuple(batch2.shape)} {len(taps)} taps: max|d| {err:.3e}")
        require(err <= K3_TOL, f"k3 max|d| {err}")
        k3_err = max(k3_err, err)

    # -- K2 against its plain version -------------------------------------
    # config #2's shape and its kernel's partial 64 x 32 tiles; C = 1 (the
    # generic kernel, 32-tiles); 33 + 17 taps on 32-tiles (C = 3 with Lab)
    # and on 16-tiles (C = 6 and C = 8: their 32-tile windows do not fit);
    # 1 + 1 taps
    wide_b, wide_u = gauss_taps(33, 33 / 7.0), gauss_taps(17, 17 / 9.0)
    k2_err = 0.0
    for shape, bt, ut, lab in (
            ((N2, H2, W2, C), blur2, unsharp2, True),
            ((N2, H2, W2, C), blur2, unsharp2, False),
            ((2, 37, 45, 3), blur2, unsharp2, True),
            ((2, 100, 150, 3), blur2, unsharp2, True),
            ((2, 100, 150, 3), blur2, unsharp2, False),
            ((1, 100, 33, 1), blur2, unsharp2, False),
            ((1, 40, 50, 3), wide_b, wide_u, True),
            ((1, 37, 45, 6), wide_b, wide_u, False),
            ((1, 40, 50, 8), wide_b, wide_u, False),
            ((2, 37, 45, 3), (1.0,), (1.0,), True)):
        x = batch2 if shape == tuple(batch2.shape) else rand(*shape)
        err = max_err(fp.blur_unsharp_kernel(x, bt, ut, GAIN, lab),
                      fp._blur_unsharp_plain(x, bt, ut, GAIN, lab))
        torch.cuda.synchronize()
        tol = K2_LAB_TOL if lab else K2_TOL
        print(f"k2 {shape} {len(bt)} + {len(ut)} taps lab={lab}: max|d| "
              f"{err:.3e} (tolerance {tol})")
        require(err <= tol, f"k2 {shape} lab={lab} max|d| {err}")
        k2_err = max(k2_err, err)

    # -- the config #2 main path, end to end -------------------------------
    def fused2_route():
        return fp.fused_blur_unsharp_pipeline(
            flat2, SIGMA, SIGMA_UNSHARP, GAIN, C, in_shape=(N2, H2, W2, C),
            lab_roundtrip=True)

    def op2_route():
        return Image(batch2).gaussian_blur(0.0, SIGMA) \
            .unsharp_mask(0.0, SIGMA_UNSHARP, GAIN, 0.0) \
            .transform_colorspace("lab").transform_colorspace("srgb").data

    for key in gk.LAUNCHES:
        gk.LAUNCHES[key] = 0
    fused2 = fused2_route()
    torch.cuda.synchronize()
    ops2 = op2_route()
    torch.cuda.synchronize()
    launches2 = dict(gk.LAUNCHES)
    print(f"config #2 main path launches: {launches2}")
    require(launches2["k2"] == 1 and launches2["k2p"] == 0 and
            launches2["k3"] >= 2, f"launches {launches2}")
    for out in (fused2, ops2):
        require(out.shape == (N2, H2, W2, C), f"shape {out.shape}")
        require(bool(torch.isfinite(out).all()), "non-finite output")
    ref2 = fp.reference_blur_unsharp_f64(batch2[:1].cpu().numpy(), SIGMA,
                                         SIGMA_UNSHARP, GAIN, True)
    db_fused2 = psnr(fused2[:1].cpu().numpy(), ref2)
    db_routes2 = psnr(fused2.cpu().numpy(), ops2.cpu().numpy())
    print(f"config #2 fused route vs float64 (image 0): {db_fused2:.2f} dB")
    print(f"config #2 fused route vs op route ({N2} images): "
          f"{db_routes2:.2f} dB")
    require(db_fused2 >= 100.0, f"config #2 fused route {db_fused2} dB")
    require(db_routes2 >= 60.0, f"config #2 routes agree at {db_routes2} dB")

    # K3 at the op route's two shapes: the blur's taps and the unsharp's
    k3_taps2 = (taps15, gaussian_kernel_1d(0.0, SIGMA_UNSHARP))
    k3_ms2 = median_ms(*(lambda t=t: gk.separable_blur(batch2, t)
                         for t in k3_taps2))
    k3_dev2 = device_ms(*(lambda t=t: gk.separable_blur(batch2, t)
                          for t in k3_taps2))
    for taps, ms, dev_ms in zip(k3_taps2, k3_ms2, k3_dev2):
        tb = bound(2 * 4 * batch2.numel(), 2 * 2 * len(taps) * batch2.numel())
        print(f"k3 config #2 op route {tuple(batch2.shape)} {len(taps)} taps: "
              f"kernel {ms:.4f} ms ({dev_ms:.4f} device-only), bound "
              f"{tb[0]:.4f} ms ({tb[1]}) [{name_limit}]")

    k2_ms, k2_plain_ms = median_ms(
        lambda: fp.blur_unsharp_kernel(batch2, blur2, unsharp2, GAIN, True),
        lambda: fp._blur_unsharp_plain(batch2, blur2, unsharp2, GAIN, True))
    k2_dev, = device_ms(
        lambda: fp.blur_unsharp_kernel(batch2, blur2, unsharp2, GAIN, True))
    fused2_ms, op2_ms = median_ms(fused2_route, op2_route)
    mp2 = N2 * H2 * W2 / 1e6
    print(f"k2 config #2 {(N2, H2, W2, C)} Lab: kernel {k2_ms:.4f} ms = "
          f"{mp2 / k2_ms * 1e3:.1f} MP/s ({k2_dev:.4f} device-only), plain "
          f"{k2_plain_ms:.4f} ms = "
          f"{mp2 / k2_plain_ms * 1e3:.1f} MP/s [{name_limit}]")
    # the two separable stencils' multiply-adds; Lab's powf and cbrtf are
    # not counted
    k2_bound = bound(2 * 4 * batch2.numel(),
                     2 * 2 * (len(blur2) + len(unsharp2)) * batch2.numel())
    print(f"k2 bound {k2_bound[0]:.4f} ms ({k2_bound[1]})")
    print(f"config #2 end to end: fused route {fused2_ms:.4f} ms = "
          f"{mp2 / fused2_ms * 1e3:.1f} MP/s, op route {op2_ms:.4f} ms = "
          f"{mp2 / op2_ms * 1e3:.1f} MP/s (input {mp2:.3f} MP/step, median "
          f"of {RUNS}) [{name_limit}]")

    # -- K2p against K2 and its plain version -----------------------------
    # config #2 (its 64 x 32 tiles, 8160 of them on the persistent grid);
    # partial tiles and fewer tiles than SMs; one tile row; a tile count
    # that leaves a tail on the grid; 33 + 17 taps on the generic kernel's
    # 32 x 32 tiles.  K2p must equal K2 on every value.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k2p_err = 0.0
    for shape, bt, ut in (
            ((N2, H2, W2, C), blur2, unsharp2),
            ((2, 37, 45, 3), blur2, unsharp2),
            ((1, 8, 128, 3), blur2, unsharp2),
            ((2, 300, 500, 3), blur2, unsharp2),
            ((1, 40, 50, 3), gauss_taps(33, 33 / 7.0),
             gauss_taps(17, 17 / 9.0))):
        x = batch2 if shape == tuple(batch2.shape) else rand(*shape)
        got = fp.blur_unsharp_pipe_kernel(x, bt, ut, GAIN)
        k2_out = fp.blur_unsharp_kernel(x, bt, ut, GAIN, True)
        err = max_err(got, fp._blur_unsharp_pipe_plain(x, bt, ut, GAIN))
        torch.cuda.synchronize()
        ndiff = int((got != k2_out).sum())
        tw, th = (64, 32) if (len(bt), len(ut)) == (15, 9) else (32, 32)
        ntiles = shape[0] * -(-shape[1] // th) * -(-shape[2] // tw)
        print(f"k2p {shape} {len(bt)} + {len(ut)} taps ({ntiles} tiles of "
              f"{tw} x {th}, {sms} SMs): {ndiff} of {got.numel()} values "
              f"differ from k2; max|d| {err:.3e} vs plain (tolerance "
              f"{K2_LAB_TOL})")
        require(ndiff == 0, f"k2p and k2 differ on {ndiff} values at {shape}")
        require(err <= K2_LAB_TOL, f"k2p {shape} max|d| {err}")
        k2p_err = max(k2p_err, err)

    # -- the config #2 pipelined fused route, end to end --------------------
    def pipe2_route():
        return fp.fused_blur_unsharp_pipeline(
            flat2, SIGMA, SIGMA_UNSHARP, GAIN, C, in_shape=(N2, H2, W2, C),
            lab_roundtrip=True, pipelined=True)

    for key in gk.LAUNCHES:
        gk.LAUNCHES[key] = 0
    pipe2 = pipe2_route()
    torch.cuda.synchronize()
    launches2p = dict(gk.LAUNCHES)
    print(f"config #2 pipelined route launches: {launches2p}")
    require(launches2p["k2p"] == 1 and launches2p["k2"] == 0,
            f"launches {launches2p}")
    require(pipe2.shape == (N2, H2, W2, C), f"shape {pipe2.shape}")
    require(bool(torch.isfinite(pipe2).all()), "non-finite output")
    db_pipe2 = psnr(pipe2[:1].cpu().numpy(), ref2)
    db_pipe_routes2 = psnr(pipe2.cpu().numpy(), ops2.cpu().numpy())
    print(f"config #2 pipelined route vs float64 (image 0): {db_pipe2:.2f} "
          "dB")
    print(f"config #2 pipelined route vs op route ({N2} images): "
          f"{db_pipe_routes2:.2f} dB")
    require(db_pipe2 >= 100.0, f"config #2 pipelined route {db_pipe2} dB")
    require(db_pipe_routes2 >= 60.0,
            f"config #2 pipelined and op routes agree at {db_pipe_routes2} dB")

    k2p_ms, k2_lab_ms, k2p_plain_ms, k2_nolab_ms = median_ms(
        lambda: fp.blur_unsharp_pipe_kernel(batch2, blur2, unsharp2, GAIN),
        lambda: fp.blur_unsharp_kernel(batch2, blur2, unsharp2, GAIN, True),
        lambda: fp._blur_unsharp_pipe_plain(batch2, blur2, unsharp2, GAIN),
        lambda: fp.blur_unsharp_kernel(batch2, blur2, unsharp2, GAIN, False))
    k2p_dev, k2_dev_again = device_ms(
        lambda: fp.blur_unsharp_pipe_kernel(batch2, blur2, unsharp2, GAIN),
        lambda: fp.blur_unsharp_kernel(batch2, blur2, unsharp2, GAIN, True))
    pipe2_ms, seq2_ms = median_ms(pipe2_route, fused2_route)
    print(f"k2p config #2 {(N2, H2, W2, C)} Lab: kernel {k2p_ms:.4f} ms = "
          f"{mp2 / k2p_ms * 1e3:.1f} MP/s ({k2p_dev:.4f} device-only), k2 "
          f"{k2_lab_ms:.4f} ms ({k2_dev_again:.4f} device-only, same call), "
          "plain "
          f"{k2p_plain_ms:.4f} ms, bound {k2_bound[0]:.4f} ms "
          f"({k2_bound[1]}) [{name_limit}]")
    print(f"k2 without Lab {k2_nolab_ms:.4f} ms: the Lab epilogue's share "
          f"of k2 is {k2_lab_ms - k2_nolab_ms:.4f} ms [{name_limit}]")
    print(f"config #2 end to end: pipelined route (K2p) {pipe2_ms:.4f} ms = "
          f"{mp2 / pipe2_ms * 1e3:.1f} MP/s, sequential fused route (K2) "
          f"{seq2_ms:.4f} ms = {mp2 / seq2_ms * 1e3:.1f} MP/s (median of "
          f"{RUNS}) [{name_limit}]")

    # == config #3: Otsu -> open/close square:1 -> edge 1 ==================
    from imagemagick_tpu_torch.models import pipelines
    from imagemagick_tpu_torch.ops import threshold as th

    batch3 = rand(N3, H3, W3, 1)
    rows3 = batch3.reshape(N3, H3 * W3)

    # -- K4 against its plain version, exact -------------------------------
    # config #3's rows (16-byte aligned); the HDRI vector (unaligned tail,
    # out-of-range values, NaN); rows whose starts fall 4, 8 and 12 bytes
    # past a 16-byte boundary; one row of 2^24 + 5 values (a bin count
    # past float32's exact integers); 1024 rows shorter than a block; a
    # 90 %-white page and a near-white one (about 16 bins)
    hdri = rand(5 * 256 * 512 + 333)
    hdri[::97] = -0.25
    hdri[1::101] = 1.75
    hdri[2::103] = 1e9
    hdri[3::107] = -1e9
    hdri[4::109] = float("nan")
    skewed = torch.where(rand(N3, H3 * W3) < 0.9, 1.0, rows3)
    near_white = 0.94 + 0.06 * rand(N3, H3 * W3)
    k4_inputs = [("config #3", rows3), ("HDRI vector", hdri[None])]
    k4_inputs += [(f"rowlen % 4 = {k}", rand(N3, H3 * W3 + k))
                  for k in (1, 2, 3)]
    k4_inputs += [("one long row", rand(1, 2 ** 24 + 5)),
                  ("1024 short rows", rand(1024, 37)),
                  ("90 % white", skewed), ("near-white", near_white)]
    k4_err = 0.0
    for name, x in k4_inputs:
        got = gk.histogram256(x)
        ref = gk.histogram256_plain(x)
        torch.cuda.synchronize()
        k4_err = max(k4_err, max_err(got, ref))
        ndiff = int((got != ref).sum())
        sums = got.double().sum(1)
        print(f"k4 {name} {tuple(x.shape)}: {ndiff} of {got.numel()} counts "
              f"differ, {int((ref > 0).sum(1).max())} bins a row at most")
        require(ndiff == 0 and bool((sums == x.shape[1]).all()),
                f"k4 {name}")
    per_call, names = kernels_per_call(lambda: gk.histogram256(rows3),
                                       "histogram256")
    print(f"k4 config #3: one call runs {per_call:g} CUDA kernel(s) {names}")
    require(per_call == 1, f"k4 runs {per_call} kernels a call: {names}")

    # -- K5 against its plain version, exact -------------------------------
    k5_err = 0.0
    for shape in ((N3, H3, W3),) + K5_SHAPES:
        x = batch3[..., 0] if shape == (N3, H3, W3) else rand(*shape)
        t = 0.3 + 0.4 * rand(shape[0])
        got = gk.fused_bilevel_morph_edge(x, t)
        ref = gk._morph_edge_reference(x, t)
        torch.cuda.synchronize()
        k5_err = max(k5_err, max_err(got, ref))
        ndiff = int((got != ref).sum())
        print(f"k5 {shape}, one threshold per image: {ndiff} pixels differ")
        require(ndiff == 0, f"k5 {shape}")

    # -- the config #3 main path, end to end, by each route ----------------
    def fused3_route():
        return gk.fused_bilevel_morph_edge(
            batch3, th.auto_threshold_values(batch3, "otsu"))

    def op3_route():
        return pipelines.document_binarize()(batch3)

    for key in gk.LAUNCHES:
        gk.LAUNCHES[key] = 0
    fused3 = fused3_route()
    torch.cuda.synchronize()
    launches3f = dict(gk.LAUNCHES)
    for key in gk.LAUNCHES:
        gk.LAUNCHES[key] = 0
    ops3 = op3_route()
    torch.cuda.synchronize()
    launches3o = dict(gk.LAUNCHES)
    print(f"config #3 main path launches: fused route {launches3f}, op "
          f"route {launches3o}")
    require(launches3f["k4"] >= 1 and launches3f["k5"] == 1 and
            launches3o["k4"] >= 1, "config #3 launches")
    for out in (fused3, ops3):
        require(out.shape == (N3, H3, W3, 1), f"shape {out.shape}")
        require(bool(((out == 0) | (out == 1)).all()), "not a 0/1 image")
    ndiff = int((fused3 != ops3).sum())
    print(f"config #3 fused route vs op route ({N3} images): {ndiff} "
          f"pixels differ; edge share {float(fused3.mean()):.5f}")
    require(ndiff == 0, "config #3 routes differ")
    t3 = th.auto_threshold_values(batch3, "otsu")
    pages = batch3[..., 0].cpu().numpy()
    j_port = [round(float(t) * 255) for t in t3.cpu()]
    j_ref = [otsu_bin_f64(page) for page in pages]
    print(f"config #3 Otsu bins {j_port}, float64 numpy {j_ref}")
    require(j_port == j_ref, "config #3 Otsu vs float64 numpy")
    _, ref3 = document_binarize_f64(pages[0])
    ndiff = int((fused3[0, ..., 0].cpu().numpy() != ref3).sum())
    print(f"config #3 image 0 vs the numpy op chain: {ndiff} pixels differ")
    require(ndiff == 0, "config #3 vs numpy")

    k4_ms, k4_plain_ms = median_ms(lambda: gk.histogram256(rows3),
                                   lambda: gk.histogram256_plain(rows3))
    k4_skew_ms, histc_ms = median_ms(
        lambda: gk.histogram256(skewed),
        lambda: torch.histc(rows3, 256, -0.5 / 255, 255.5 / 255))
    k4_pages = (("uniform", rows3), ("90 % white", skewed),
                ("near-white", near_white))
    k4_page_dev = device_ms(*(lambda x=x: gk.histogram256(x)
                              for _, x in k4_pages))
    k4_page_kernel = [kernel_ms(lambda x=x: gk.histogram256(x),
                                "histogram256")
                      for _, x in k4_pages]
    k5_ms, k5_plain_ms = median_ms(
        lambda: gk.fused_bilevel_morph_edge(batch3, t3),
        lambda: gk._morph_edge_reference(batch3[..., 0], t3))
    k4_dev, histc_dev, k5_dev = device_ms(
        lambda: gk.histogram256(rows3),
        lambda: torch.histc(rows3, 256, -0.5 / 255, 255.5 / 255),
        lambda: gk.fused_bilevel_morph_edge(batch3, t3))
    fused3_ms, op3_ms = median_ms(fused3_route, op3_route)
    mp3 = N3 * H3 * W3 / 1e6
    k4_bound = bound(4 * rows3.numel() + 4 * N3 * 256, 2 * rows3.numel())
    # four 3x3 min/max stages and the 3x3 edge sum: 9 operations each
    k5_bound = bound(2 * 4 * batch3.numel(), 5 * 9 * batch3.numel())
    print(f"k4 config #3 {tuple(rows3.shape)}: kernel {k4_ms:.4f} ms "
          f"({k4_dev:.4f} device-only), plain {k4_plain_ms:.4f} ms, 90 % "
          f"white {k4_skew_ms:.4f} ms, torch.histc {histc_ms:.4f} ms "
          f"({histc_dev:.4f} device-only), bound {k4_bound[0]:.4f} ms "
          f"({k4_bound[1]}) [{name_limit}]")
    for (page, _), dev_ms, ker_ms in zip(k4_pages, k4_page_dev,
                                         k4_page_kernel):
        print(f"k4 config #3 {page} page: {dev_ms:.4f} ms device-only, "
              f"kernel {ker_ms:.4f} ms on the profiler's clock "
              f"({ker_ms / k4_page_kernel[0]:.3f} x uniform) [{name_limit}]")
    print(f"k5 config #3 {(N3, H3, W3)}: kernel {k5_ms:.4f} ms ({k5_dev:.4f} "
          f"device-only), plain {k5_plain_ms:.4f} ms, bound "
          f"{k5_bound[0]:.4f} ms ({k5_bound[1]}) [{name_limit}]")
    print(f"config #3 end to end: fused route {fused3_ms:.4f} ms = "
          f"{mp3 / fused3_ms * 1e3:.1f} MP/s, op route {op3_ms:.4f} ms = "
          f"{mp3 / op3_ms * 1e3:.1f} MP/s (input {mp3:.3f} MP/step, median "
          f"of {RUNS}) [{name_limit}]")

    # == config #4: 4K Wiener FFT denoise ==================================
    from imagemagick_tpu_torch.ops import fourier as ft
    from imagemagick_tpu_torch.ops import fourier_kernels as fk

    batch4 = rand(N4, H4, W4, 1)
    planes4 = batch4.reshape(N4, H4, W4)         # C = 1: one plane an image
    require(fk.supported(H4, W4), "K6 declines config #4's shape")

    # -- K6a, K6b, K6c against their plain versions -----------------------
    # K6b takes composite extents only (H = 7 and 5 are prime); its plain
    # version takes any H, so K6c gets the same kind of input everywhere
    k6_err = {"k6a": 0.0, "k6b": 0.0, "k6c": 0.0}
    for shape in K6_ROW_SHAPES:
        x = planes4 if shape == (N4, H4, W4) else rand(*shape)
        pm = torch.sum(x * x, dim=(-2, -1))
        spec_ref = fk._w_forward_plain(x)
        spec = fk.w_forward(x)
        g_ref = fk._h_mask_plain(spec_ref, pm, NOISE)
        out = fk.w_inverse(g_ref)
        out_ref = fk._w_inverse_plain(g_ref)
        torch.cuda.synchronize()
        errs = {"k6a": max_err(spec, spec_ref), "k6c": max_err(out, out_ref)}
        rel = rel_err(spec, spec_ref)
        line = (f"k6 {shape} (passes {fk._radix_plan(shape[2])}): k6a max|d| "
                f"{errs['k6a']:.3e} ({rel:.3e} of max|F|), k6c "
                f"{errs['k6c']:.3e}")
        require(rel <= K6_SPEC_TOL, f"k6a {shape} {rel}")
        require(errs["k6c"] <= K6C_TOL, f"k6c {shape} {errs['k6c']}")
        if fk.supported(*shape[1:]):
            g = fk.h_mask(spec_ref, pm, NOISE)
            torch.cuda.synchronize()
            errs["k6b"] = max_err(g, g_ref)
            rel_b = rel_err(g, g_ref)
            line += (f", k6b {errs['k6b']:.3e} ({rel_b:.3e} of max|F|)")
            require(rel_b <= K6_SPEC_TOL, f"k6b {shape} {rel_b}")
        # K6c on a spectrum with no symmetry: Re IDFT of any g
        u = torch.complex(rand(*shape).double() * 1.4 - 0.2,
                          rand(*shape).double() * 2 - 1)
        g_any = torch.fft.fft(u, dim=-1).to(torch.complex64)
        ref_any = torch.fft.ifft(g_any.to(torch.complex128),
                                 dim=-1).real.clamp(0, 1)
        err_any = max_err(fk.w_inverse(g_any).double(), ref_any)
        torch.cuda.synchronize()
        line += f"; k6c non-Hermitian vs float64 {err_any:.3e}"
        require(err_any <= K6C_TOL, f"k6c non-Hermitian {shape} {err_any}")
        errs["k6c"] = max(errs["k6c"], err_any)
        print(line)
        for key, err in errs.items():
            k6_err[key] = max(k6_err[key], err)
    for shape in K6B_SHAPES:
        spec = torch.fft.fft(rand(*shape), dim=-1)
        pm = 50 + 150 * rand(shape[0])
        g = fk.h_mask(spec, pm, NOISE)
        g_ref = fk._h_mask_plain(spec, pm, NOISE)
        torch.cuda.synchronize()
        rel_b = rel_err(g, g_ref)
        print(f"k6b {shape} (passes {fk._radix_plan(shape[1])}): max|d| "
              f"{max_err(g, g_ref):.3e} ({rel_b:.3e} of max|F|)")
        require(rel_b <= K6_SPEC_TOL, f"k6b {shape} {rel_b}")
        k6_err["k6b"] = max(k6_err["k6b"], max_err(g, g_ref))

    # -- the config #4 main path, end to end, by each route ----------------
    wiener = pipelines.fft_wiener(NOISE)

    def fused4_route():
        return wiener(batch4)

    def op4_route():
        ft.set_fft_mode("fft")
        try:
            return wiener(batch4)
        finally:
            ft.set_fft_mode("auto")

    for key in gk.LAUNCHES:
        gk.LAUNCHES[key] = 0
    fused4 = fused4_route()
    torch.cuda.synchronize()
    launches4 = dict(gk.LAUNCHES)
    ops4 = op4_route()
    torch.cuda.synchronize()
    print(f"config #4 main path launches: {launches4}")
    require(all(launches4[k] == 1 for k in ("k6a", "k6b", "k6c")),
            f"config #4 launches {launches4}")
    for out in (fused4, ops4):
        require(out.shape == (N4, H4, W4, 1), f"shape {out.shape}")
        require(bool(torch.isfinite(out).all()), "non-finite output")
    t0 = time.perf_counter()
    ref4 = wiener_f64(batch4[0, ..., 0].cpu().numpy(), NOISE)
    f64_s = time.perf_counter() - t0
    db_fused4 = psnr(fused4[0, ..., 0].cpu().numpy(), ref4)
    db_routes4 = psnr(fused4.cpu().numpy(), ops4.cpu().numpy())
    print(f"config #4 fused route vs float64 numpy ({f64_s:.2f} s on the "
          f"host): {db_fused4:.2f} dB")
    print(f"config #4 fused route vs op route: {db_routes4:.2f} dB")
    require(db_fused4 >= 100.0, f"config #4 fused route {db_fused4} dB")
    require(db_routes4 >= 100.0, f"config #4 routes agree at {db_routes4} dB")

    pm4 = torch.sum(planes4 * planes4, dim=(-2, -1))
    spec4 = fk.w_forward(planes4)
    g4 = fk.h_mask(spec4, pm4, NOISE)
    k6a_ms, k6a_plain_ms, fft_ms = median_ms(
        lambda: fk.w_forward(planes4), lambda: fk._w_forward_plain(planes4),
        lambda: torch.fft.fft(planes4, dim=-1))

    # K6b's yardstick: cuFFT's transforms along H both ways, no mask
    def h_fft_ifft():
        return torch.fft.ifft(torch.fft.fft(spec4, dim=-2), dim=-2)

    k6b_ms, k6b_plain_ms, hfft_ms = median_ms(
        lambda: fk.h_mask(spec4, pm4, NOISE),
        lambda: fk._h_mask_plain(spec4, pm4, NOISE), h_fft_ifft)
    k6c_ms, k6c_plain_ms, ifft_ms = median_ms(
        lambda: fk.w_inverse(g4), lambda: fk._w_inverse_plain(g4),
        lambda: torch.fft.ifft(g4, dim=-1))
    k6a_dev, fft_dev, k6b_dev, hfft_dev, k6c_dev, ifft_dev = device_ms(
        lambda: fk.w_forward(planes4), lambda: torch.fft.fft(planes4, dim=-1),
        lambda: fk.h_mask(spec4, pm4, NOISE), h_fft_ifft,
        lambda: fk.w_inverse(g4), lambda: torch.fft.ifft(g4, dim=-1))
    fused4_ms, op4_ms = median_ms(fused4_route, op4_route)
    n4 = planes4.numel()
    mp4 = n4 / 1e6
    # bytes: each input read once, each output written once; operations: a
    # radix FFT's count per transform, halved for K6a and K6c (two real rows
    # per complex transform), K6b also 6 per element for the mask
    k6a_bound = bound(4 * n4 + 8 * n4, fft_flops(n4, W4) / 2)
    k6b_bound = bound(8 * n4 + 8 * n4 + 4 * N4,
                      2 * fft_flops(n4, H4) + 6 * n4)
    k6c_bound = bound(8 * n4 + 4 * n4, fft_flops(n4, W4) / 2)
    for name, ms, dev_ms, plain_ms, lib_ms, lib_dev, bnd in (
            ("k6a", k6a_ms, k6a_dev, k6a_plain_ms, fft_ms, fft_dev,
             k6a_bound),
            ("k6b", k6b_ms, k6b_dev, k6b_plain_ms, hfft_ms, hfft_dev,
             k6b_bound),
            ("k6c", k6c_ms, k6c_dev, k6c_plain_ms, ifft_ms, ifft_dev,
             k6c_bound)):
        lib = "none" if lib_ms is None else \
            f"{lib_ms:.4f} ms ({lib_dev:.4f} device-only)"
        print(f"{name} config #4 {(N4, H4, W4)}: kernel {ms:.4f} ms "
              f"({dev_ms:.4f} device-only), plain {plain_ms:.4f} ms, "
              f"library {lib}, bound {bnd[0]:.4f} ms ({bnd[1]}), "
              f"device-only at {bnd[0] / dev_ms * 100:.1f} % of the bound "
              f"[{name_limit}]")
    print("(k6a's library call is torch.fft.fft along W; k6b's yardstick, "
          "torch.fft.fft then torch.fft.ifft along H, lacks the mask; k6c's, "
          "torch.fft.ifft along W, lacks K6c's real part and clip)")
    print(f"config #4 end to end: fused route {fused4_ms:.4f} ms = "
          f"{mp4 / fused4_ms * 1e3:.1f} MP/s, op route {op4_ms:.4f} ms = "
          f"{mp4 / op4_ms * 1e3:.1f} MP/s (input {mp4:.3f} MP/step, median "
          f"of {RUNS}) [{name_limit}]")

    kernels = [
        {"name": "k1_fused_pipeline", "route": "cuda",
         "source": "imagemagick_tpu_torch/csrc/fused_pipeline.cu",
         "replaces": "imagemagick_tpu/ops/fused_pipeline.py:564",
         "launches": launches["k1"] + new5["k1"] + new5["k1_wm"] +
         cli1["k1"] + serve1["k1"] + tone["k1"] + clie["k1"] + clid["k1"] +
         clich["k1"] + cliv["k1"] + clidr["k1"] + clil["k1"] + clif["k1"] +
         srvc["k1"] + coders["k1"] + fmts["k1"] + fmts4["k1"] + strm["k1"] +
         tools["k1"] + wand["k1"] + mpp["k1"] + par["k1"],
         "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None,
         "device_ms": k1_dev, "library_device_ms": None},
        {"name": "k2_blur_unsharp", "route": "cuda",
         "source": "imagemagick_tpu_torch/csrc/blur_unsharp.cu",
         "replaces": "imagemagick_tpu/ops/fused_pipeline.py:564",
         "launches": launches2["k2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None,
         "device_ms": k2_dev, "library_device_ms": None},
        {"name": "k2p_blur_unsharp_pipe", "route": "cuda",
         "source": "imagemagick_tpu_torch/csrc/blur_unsharp_pipe.cu",
         "replaces": "imagemagick_tpu/ops/fused_pipeline.py:484",
         "launches": launches2p["k2p"], "max_abs_err": k2p_err,
         "ms": k2p_ms, "plain_ms": k2p_plain_ms, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None,
         "device_ms": k2p_dev, "library_device_ms": None},
        {"name": "k3_separable_blur", "route": "cuda",
         "source": "imagemagick_tpu_torch/csrc/separable_blur.cu",
         "replaces": "imagemagick_tpu/ops/pallas_kernels.py:38",
         "launches": launches["k3"] + launches2["k3"] + cli1["k3"] +
         fx["k3"] + clie["k3"] + vis["k3"] + cliv["k3"] + vfx["k3"] +
         clil["k3"] + strm["k3"] + tools["k3"] + wand["k3"] + mpp["k3"] +
         par["k3"],
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "library_ms": None,
         "device_ms": k3_dev, "library_device_ms": None},
        {"name": "k4_histogram256", "route": "cuda",
         "source": "imagemagick_tpu_torch/csrc/histogram256.cu",
         "replaces": "imagemagick_tpu/ops/pallas_kernels.py:351",
         "launches": launches3f["k4"] + launches3o["k4"] + tone["k4"] +
         cliv["k4"] + clif["k4"] + coders["k4"] + fmts["k4"] +
         fmts4["k4"] + strm["k4"] + wand["k4"] + mpp["k4"] + par["k4"],
         "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain_ms,
         "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
         "library_ms": histc_ms,
         "device_ms": k4_dev, "library_device_ms": histc_dev,
         "kernel_ms": k4_page_kernel[0]},
        {"name": "k5_morph_edge", "route": "cuda",
         "source": "imagemagick_tpu_torch/csrc/morph_edge.cu",
         "replaces": "imagemagick_tpu/ops/pallas_kernels.py:147",
         "launches": launches3f["k5"] + launches3o["k5"],
         "max_abs_err": k5_err, "ms": k5_ms, "plain_ms": k5_plain_ms,
         "bound_ms": k5_bound[0], "bound_by": k5_bound[1],
         "library_ms": None,
         "device_ms": k5_dev, "library_device_ms": None},
        {"name": "k6a_w_forward", "route": "cuda",
         "source": "imagemagick_tpu_torch/csrc/wiener_fft.cu",
         "replaces": "imagemagick_tpu/ops/fourier_pallas.py:85",
         "launches": launches4["k6a"], "max_abs_err": k6_err["k6a"],
         "ms": k6a_ms, "plain_ms": k6a_plain_ms, "bound_ms": k6a_bound[0],
         "bound_by": k6a_bound[1], "library_ms": fft_ms,
         "device_ms": k6a_dev, "library_device_ms": fft_dev},
        {"name": "k6b_h_mask", "route": "cuda",
         "source": "imagemagick_tpu_torch/csrc/wiener_fft.cu",
         "replaces": "imagemagick_tpu/ops/fourier_pallas.py:137",
         "launches": launches4["k6b"], "max_abs_err": k6_err["k6b"],
         "ms": k6b_ms, "plain_ms": k6b_plain_ms, "bound_ms": k6b_bound[0],
         "bound_by": k6b_bound[1], "library_ms": None,
         "device_ms": k6b_dev, "library_device_ms": hfft_dev},
        {"name": "k6c_w_inverse", "route": "cuda",
         "source": "imagemagick_tpu_torch/csrc/wiener_fft.cu",
         "replaces": "imagemagick_tpu/ops/fourier_pallas.py:161",
         "launches": launches4["k6c"], "max_abs_err": k6_err["k6c"],
         "ms": k6c_ms, "plain_ms": k6c_plain_ms, "bound_ms": k6c_bound[0],
         "bound_by": k6c_bound[1], "library_ms": ifft_ms,
         "device_ms": k6c_dev, "library_device_ms": ifft_dev},
    ]
    walks = tools["walks"]
    for k, fs in sorted(walks["fs"].items(), reverse=True):
        kernels.append(
            {"name": f"palette_walk_fs_k{k}", "route": "cuda",
             "source": "imagemagick_tpu_torch/csrc/palette_walk.cu",
             "replaces": "none: imagemagick_tpu/ops/quantize.py:200 "
                         "(floyd_steinberg, an XLA loop)",
             "launches": fs["launches"] +
             (wand["walk_fs"] if k == 16 else 0),
             "max_abs_err": fs["max_abs_err"],
             "ms": fs["ms"],
             "plain_ms": fs["plain_ms"], "bound_ms": fs["bound"][0],
             "bound_by": fs["bound"][1], "library_ms": None,
             "device_ms": fs["device_ms"], "library_device_ms": None,
             "shape": [WALK_N, IO_H, IO_W, C, k],
             "plain_shape": [WALK_N, WALK_TOP, IO_W, C, k],
             "plain_on": "host", "sm_mhz": fs["bound"][2],
             "step_cycles": walks["step_cycles"],
             "small_ms": walks["fs_small"][0],
             "small_plain_ms": walks["fs_small"][1]})
    rm_ms, rm_dev, rm_plain, rm_bound = walks["rm"]
    kernels.append(
        {"name": "palette_walk_riemersma", "route": "cuda",
         "source": "imagemagick_tpu_torch/csrc/palette_walk.cu",
         "replaces": "none: imagemagick_tpu/ops/quantize.py:284 "
                     "(riemersma, an XLA loop)",
         "launches": walks["rm_launches"], "max_abs_err": walks["rm_err"],
         "ms": rm_ms, "plain_ms": rm_plain, "bound_ms": rm_bound[0],
         "bound_by": rm_bound[1], "library_ms": None,
         "device_ms": rm_dev, "library_device_ms": None,
         "shape": [1, WALK_SIDE, WALK_SIDE, C, 16],
         "plain_shape": [1, WALK_SIDE, WALK_SIDE, C, 16], "plain_on": "host",
         "sm_mhz": rm_bound[2], "step_cycles": walks["step_cycles"],
         "small_ms": walks["rm_small"][0],
         "small_plain_ms": walks["rm_small"][1]})
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s "
          f"[{name_limit}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
