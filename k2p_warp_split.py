#!/usr/bin/env python3
"""Time kernel K2p at other splits of its warps, and without each role's work.

K2p (``imagemagick_tpu_torch/csrc/blur_unsharp_pipe.cu``) gives config
#2's kernel one load warp and a fixed number of warps to the stencils
(compute) and to the Lab epilogue and the stores (Lab).  This script
builds copies of the source, one ``nvcc`` per copy, all started together,
into ``imagemagick_tpu_torch/_build/split/``: copies with other warp
counts, which must equal K2 bit for bit on config #2's batch (8 x 1080 x
1920 x 3, blur 0x2, unsharp 0x1, gain 1, Lab), and timing-only copies
whose output is not checked: without the Lab math, without the Lab
warps' math and stores, without the stencil passes, without the x window
copies, and with a suspend-time hint on the mbarrier waits.  It times K2
and every copy with CUDA events, per call (``chip_smoke.median_ms``) and
device-only (``chip_smoke.device_ms``), all interleaved, beside each
copy's registers and spills from ``ptxas``.  The first copy is the source
as it ships.

Run from the repository root on a machine with one CUDA card:
``python3 k2p_warp_split.py [--seed N]``.  It fails without a card.
"""

import argparse
import ctypes
import re
import subprocess
import sys

import torch

SPLITS = ((15, 16), (12, 16), (11, 20), (19, 12), (16, 8), (8, 8))
N, H, W, C = 8, 1080, 1920, 3
LAB = "          lab_roundtrip(v[r][0], v[r][1], v[r][2]);\n"
STORES = "            for (int c = 0; c < C; ++c) dst[at[r] + c] = v[r][c];\n"
PASSES = ("bu::vertical_blur<T>(", "bu::horizontal_blur<T>(",
          "bu::vertical_unsharp<T>(")
MIX = ("      float res[T::PER_THREAD][T::CM][T::RUN4];\n"
       "      bu::unsharp_mix<T>(p, k, A, B, res, tid);\n")
COPY = ("      load_window(p, k, t, slot_shift(p, k, t), xslot + s * L.xs,\n"
        "                  x_full + s, tid);\n")
WAIT = "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
TIMING_ONLY = {
    "no Lab math": [(LAB, "")],
    "no Lab math, no stores": [
        (LAB, ""),
        (STORES, "            if (v[r][0] == -1.f) dst[at[r]] = v[r][1];\n")],
    "no stencil passes": [(call, "if (false) " + call) for call in PASSES] + [
        (MIX, "      float res[T::PER_THREAD][T::CM][T::RUN4];\n"
              "      for (auto& a : res) for (auto& b : a) for (auto& c : b) "
              "c = 0.5f;\n")],
    "no x window copies": [(COPY, "")],
    "mbarrier waits with a 1 ms suspend hint": [
        (WAIT, WAIT.replace("%2;", "%2, 1000000;"))],
}


def split_text(src: str, compute: int, lab: int) -> str:
    text = re.sub(r"constexpr int CONFIG2_COMPUTE = \d+;",
                  f"constexpr int CONFIG2_COMPUTE = {compute * 32};", src)
    return re.sub(r"constexpr int CONFIG2_LAB = \d+;",
                  f"constexpr int CONFIG2_LAB = {lab * 32};", text)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2p_warp_split: no CUDA card")
    from chip_smoke import card, device_ms, median_ms, require
    from imagemagick_tpu_torch import _build
    from imagemagick_tpu_torch.ops import fused_pipeline as fp

    name_limit = card()
    print(name_limit)
    src = (_build._SRC / "blur_unsharp_pipe.cu").read_text()
    shipped = tuple(int(re.search(rf"constexpr int {role} = (\d+);",
                                  src).group(1)) // 32
                    for role in ("CONFIG2_COMPUTE", "CONFIG2_LAB"))
    require(shipped == SPLITS[0], f"the source ships {shipped}")
    copies = {f"1 load + {c} compute + {lab} Lab warps "
              f"({32 * (1 + c + lab)} threads)": split_text(src, c, lab)
              for c, lab in SPLITS}
    for name, edits in TIMING_ONLY.items():
        text = src
        for old, new in edits:
            require(old in text, f"blur_unsharp_pipe.cu lacks {old!r}")
            text = text.replace(old, new)
        copies[f"{name} (timing only)"] = text
    out = _build._OUT / "split"
    out.mkdir(parents=True, exist_ok=True)
    builds = []
    for i, (name, text) in enumerate(copies.items()):
        cu = out / f"k2p_{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.FLAGS, "-I", str(_build._SRC),
               "-shared", "-o", str(so), str(cu)]
        builds.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, so, proc in builds:
        log = proc.communicate()[0]
        require(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        lib = ctypes.CDLL(str(so))
        lib.k2p_blur_unsharp_pipe.argtypes = \
            _build._SIGNATURES["k2p_blur_unsharp_pipe"]
        lib.k2p_blur_unsharp_pipe.restype = ctypes.c_int
        # ptxas reports the generic kernel, then config #2's
        libs[name] = (lib, "/".join(regs), "/".join(spills))

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.rand((N, H, W, C), generator=gen, device=dev)
    blur, unsharp = fp.blur_unsharp_taps(H, W, 2.0, 1.0)
    taps = torch.tensor(blur + unsharp, dtype=torch.float32)  # host
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib):
        y = torch.empty_like(x)
        err = lib.k2p_blur_unsharp_pipe(x.data_ptr(), y.data_ptr(),
                                        taps.data_ptr(), N, H, W, len(blur),
                                        len(unsharp), 1.0, stream)
        _build.check(err, "k2p_blur_unsharp_pipe")
        return y

    def k2(lab=True):
        return fp.blur_unsharp_kernel(x, blur, unsharp, 1.0, lab)

    ref = k2()
    for name, (lib, _, _) in libs.items():
        got = launch(lib)
        torch.cuda.synchronize()
        if "timing only" not in name:
            require(torch.equal(got, ref), f"{name} differs from K2")
    fns = [k2, lambda: k2(False)] + [lambda lib=lib: launch(lib)
                                     for lib, _, _ in libs.values()]
    times, dev_times = median_ms(*fns), device_ms(*fns)
    for label, ms, dv in zip(("with Lab", "without Lab"), times, dev_times):
        print(f"k2 {(N, H, W, C)} {label}: {ms:.4f} ms per call, {dv:.4f} "
              f"device-only [{name_limit}]")
    for (name, (_, regs, spills)), ms, dv in zip(libs.items(), times[2:],
                                                  dev_times[2:]):
        checked = "" if "timing only" in name else ", equal to K2"
        print(f"k2p {name}: {ms:.4f} ms per call, {dv:.4f} device-only; "
              f"registers {regs}, spill stores {spills} bytes (generic / "
              f"config #2 kernel){checked} [{name_limit}]")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
