"""The -fx expression language over PyTorch tensors.

Port of ``imagemagick_tpu/ops/fx.py``, whole.  The reference
(MagickCore/fx.c) tokenizes an expression, compiles it to RPN and
interprets it per pixel.  Here, as in the JAX package, the expression is
parsed once on the host by a recursive-descent parser into closures over
an environment, and each closure runs as torch ops on whole planes on the
images' device, one channel at a time.

Supported surface (fx.c's operator, function and constant tables):
  * operators: ?: || && | & == != < <= > >= + - * / % ^(pow) unary -+!~
  * functions: abs acos acosh asin asinh atan atanh atan2 ceil clamp cos
    cosh debug drc erf exp floor gauss gcd hypot if int isnan ln log
    logtwo max min mod not pow rand round sign sin sinc sinh sqrt squish
    tan tanh trunc alt (``j0``, ``j1``, ``jinc`` and ``airy``, which the
    JAX table drops, raise "unknown function" here too)
  * constants: e pi phi epsilon opaque transparent quantumrange
    quantumscale maxrgb
  * symbols: u v s (and ``u[n]``), channel suffixes .r/.g/.b/.a/...,
    p[dx,dy] relative and p{x,y} absolute pixel refs, i j w h, intensity,
    luma, luminance, hue, saturation, lightness
  * statements: ``expr; expr; ...`` with user variables ``name = expr;``

Pixel values are normalized to [0, 1]; quantumrange follows Q16 (65535).

On the card: every constant is a 0-d float32 tensor on the images' device
(CUDA divides by a host scalar through its reciprocal, an ulp off the
CPU's true division); ``u[n]`` reads its index back to the host, as the
JAX function does; ``rand`` draws from a ``torch.Generator`` on the
device, rewound for each channel so that every channel gets the same
draws (the JAX function starts every channel from the same key).

Where this differs from the JAX function (each kept visible by a test):
``gcd(x, y)`` is Euclid's gcd of its arguments rounded to integers (the
JAX one returns ``x``); a channel suffix on a pixel reference
(``p.r[1,0]``; ``p[1,0].r`` is a bad token in both) reads that channel at
the offset (the JAX one drops the offset); and ``p[dx,dy]``/``p{x,y}``
gather each image of a batch from itself (the JAX one indexes the batch
axis with the row: it raises on a relative reference and reads the wrong
pixel on an absolute one).
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Sequence

import torch

_TOKEN_RE = re.compile(r"""
    (?P<num>(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?%?)
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*(?:\.[A-Za-z_][A-Za-z_0-9]*)*)
  | (?P<op><=|>=|==|!=|&&|\|\||[-+*/%^<>!~?:;,=(){}\[\]])
  | (?P<ws>\s+)
""", re.VERBOSE)


def _tokenize(src: str) -> List[str]:
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise ValueError(f"fx: bad token at {src[pos:pos+10]!r}")
        pos = m.end()
        if m.lastgroup != "ws":
            out.append(m.group())
    return out


_CONSTANTS = {
    "e": math.e, "pi": math.pi, "phi": (1 + math.sqrt(5)) / 2,
    "epsilon": 1e-15, "opaque": 1.0, "transparent": 0.0,
    "quantumrange": 65535.0, "quantumscale": 1.0 / 65535.0,
    "maxrgb": 65535.0,
}

_CHANNEL_NAMES = {"r": 0, "red": 0, "g": 1, "green": 1, "b": 2, "blue": 2,
                  "a": -1, "alpha": -1, "c": 0, "cyan": 0, "m": 1,
                  "magenta": 1, "y": 2, "yellow": 2, "k": 3, "black": 3}

_LUMA = (0.212656, 0.715158, 0.072186)


def _luma(im: torch.Tensor) -> torch.Tensor:
    """Rec709 luma of the first three channels, a missing channel read
    as the last one (the JAX function's clamped gather)."""
    last = im.shape[-1] - 1
    return (_LUMA[0] * im[..., 0] + _LUMA[1] * im[..., min(1, last)] +
            _LUMA[2] * im[..., min(2, last)])


class _Env:
    """Evaluation environment for one channel pass."""

    def __init__(self, images: Sequence[torch.Tensor], channel: int,
                 generator: torch.Generator,
                 variables: Dict[str, torch.Tensor]):
        self.images = images
        self.channel = channel
        self.generator = generator
        self.vars = variables
        self.device = images[0].device
        h, w = images[0].shape[-3], images[0].shape[-2]
        self.h, self.w = h, w
        ar = torch.arange
        f32 = torch.float32
        self.jj = ar(h, dtype=f32, device=self.device)[:, None] * \
            torch.ones((1, w), dtype=f32, device=self.device)
        self.ii = torch.ones((h, 1), dtype=f32, device=self.device) * \
            ar(w, dtype=f32, device=self.device)[None, :]

    def const(self, v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    def pixel(self, img_idx: int, channel: Optional[int] = None,
              dx=None, dy=None, absolute=False):
        img = self.images[min(img_idx, len(self.images) - 1)]
        ch = self.channel if channel is None else (
            img.shape[-1] - 1 if channel == -1 else min(channel,
                                                        img.shape[-1] - 1))
        plane = img[..., ch]
        if dx is None:
            return plane
        h, w = self.h, self.w
        if absolute:
            xi = torch.clamp(torch.round(dx).to(torch.int64), 0, w - 1)
            yi = torch.clamp(torch.round(dy).to(torch.int64), 0, h - 1)
        else:
            xi = torch.clamp(torch.round(self.ii + dx).to(torch.int64),
                             0, w - 1)
            yi = torch.clamp(torch.round(self.jj + dy).to(torch.int64),
                             0, h - 1)
        yi, xi = torch.broadcast_tensors(yi, xi)
        if yi.dim() < 2:
            yi, xi = yi.reshape(1, 1), xi.reshape(1, 1)
        if plane.dim() == 2:
            return plane[yi, xi]
        # a batch: each image gathers from itself
        n = torch.arange(plane.shape[0], device=plane.device)
        return plane[n.view(-1, 1, 1), yi, xi]


class _Parser:
    """Recursive-descent parser producing closures over _Env."""

    def __init__(self, tokens: List[str]):
        self.toks = tokens
        self.pos = 0

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self):
        t = self.peek()
        self.pos += 1
        return t

    def expect(self, t):
        got = self.next()
        if got != t:
            raise ValueError(f"fx: expected {t!r}, got {got!r}")

    # statements: expr (';' expr)*  — the value of the last one wins
    def parse_program(self):
        exprs = [self.parse_assign()]
        while self.peek() == ";":
            self.next()
            if self.peek() is None:
                break
            exprs.append(self.parse_assign())

        def run(env):
            val = None
            for e in exprs:
                val = e(env)
            return val

        return run

    def parse_assign(self):
        # lookahead for "name = expr" (not ==)
        if (self.pos + 1 < len(self.toks)
                and re.fullmatch(r"[A-Za-z_]\w*", self.toks[self.pos] or "")
                and self.toks[self.pos + 1] == "="
                and self.toks[self.pos].lower() not in _CONSTANTS):
            name = self.next()
            self.next()  # '='
            rhs = self.parse_assign()

            def assign(env, name=name, rhs=rhs):
                v = rhs(env)
                env.vars[name] = v
                return v

            return assign
        return self.parse_ternary()

    def parse_ternary(self):
        cond = self.parse_or()
        if self.peek() == "?":
            self.next()
            a = self.parse_assign()
            self.expect(":")
            b = self.parse_ternary()
            return lambda env: torch.where(cond(env) != 0, a(env), b(env))
        return cond

    def _binop_level(self, sub, ops: Dict[str, Callable]):
        left = sub()
        while self.peek() in ops:
            op = self.next()
            right = sub()
            left = (lambda env, f=ops[op], l=left, r=right:
                    f(l(env), r(env)))
        return left

    def parse_or(self):
        return self._binop_level(self.parse_and, {"||": _or})

    def parse_and(self):
        return self._binop_level(self.parse_bitor, {"&&": _and})

    def parse_bitor(self):
        return self._binop_level(self.parse_bitand, {"|": _or})

    def parse_bitand(self):
        return self._binop_level(self.parse_cmp, {"&": _and})

    def parse_cmp(self):
        return self._binop_level(self.parse_add, {
            "==": lambda a, b: _f32((a - b).abs() < 1e-12),
            "!=": lambda a, b: _f32((a - b).abs() >= 1e-12),
            "<": lambda a, b: _f32(a < b),
            "<=": lambda a, b: _f32(a <= b),
            ">": lambda a, b: _f32(a > b),
            ">=": lambda a, b: _f32(a >= b),
        })

    def parse_add(self):
        return self._binop_level(self.parse_mul, {
            "+": lambda a, b: a + b,
            "-": lambda a, b: a - b,
        })

    def parse_mul(self):
        return self._binop_level(self.parse_pow, {
            "*": lambda a, b: a * b,
            "/": lambda a, b: a / torch.where(
                b.abs() < 1e-15, torch.where(b < 0, -1e-15, 1e-15), b),
            "%": _mod,
        })

    def parse_pow(self):
        left = self.parse_unary()
        if self.peek() == "^":
            self.next()
            right = self.parse_pow()  # right-associative
            return lambda env: torch.pow(left(env), right(env))
        return left

    def parse_unary(self):
        t = self.peek()
        if t == "-":
            self.next()
            sub = self.parse_unary()
            return lambda env: -sub(env)
        if t == "+":
            self.next()
            return self.parse_unary()
        if t in ("!", "~"):
            self.next()
            sub = self.parse_unary()
            return lambda env: _f32(sub(env).abs() < 1e-15)
        return self.parse_primary()

    def parse_primary(self):
        t = self.next()
        if t is None:
            raise ValueError("fx: unexpected end of expression")
        if t == "(":
            e = self.parse_assign()
            self.expect(")")
            return e
        if re.match(r"^(?:\d|\.\d)", t):
            v = float(t[:-1]) / 100.0 if t.endswith("%") else float(t)
            return lambda env: env.const(v)
        if not re.match(r"[A-Za-z_]", t):
            raise ValueError(f"fx: unexpected token {t!r}")
        return self._parse_name(t)

    def _parse_name(self, name: str):
        low = name.lower()
        base, _, suffix = low.partition(".")

        # function call?
        if self.peek() == "(" and base not in ("u", "v", "s", "p"):
            return self._parse_call(low)

        if low in _CONSTANTS:
            v = _CONSTANTS[low]
            return lambda env: env.const(v)

        if base in ("u", "v", "s", "p") or low in ("i", "j", "w", "h",
                                                   "intensity", "luma",
                                                   "luminance", "hue",
                                                   "saturation", "lightness"):
            return self._parse_image_ref(base, suffix)

        if low in _CHANNEL_NAMES:  # a bare channel name: that channel of u
            ch = _CHANNEL_NAMES[low]
            return lambda env: env.pixel(0, ch)

        # a user variable
        return lambda env: env.vars.get(name, env.const(0.0))

    def _parse_image_ref(self, base: str, suffix: str):
        if base == "i":
            return lambda env: env.ii
        if base == "j":
            return lambda env: env.jj
        if base == "w":
            return lambda env: env.const(float(env.w))
        if base == "h":
            return lambda env: env.const(float(env.h))
        if base in ("intensity", "luma"):
            return lambda env: _luma(env.images[0])
        if base == "luminance":
            def luminance(env):
                from .colorspace import srgb_to_linear
                return _luma(srgb_to_linear(env.images[0]))
            return luminance
        if base in ("hue", "saturation", "lightness"):
            idx = {"hue": 0, "saturation": 1, "lightness": 2}[base]

            def hsl_ref(env):
                from .colorspace import rgb_to_hsl
                return rgb_to_hsl(env.images[0][..., :3])[..., idx]
            return hsl_ref

        img_idx = {"u": 0, "s": 0, "v": 1, "p": 0}[base]
        channel = None
        if suffix in _CHANNEL_NAMES:
            channel = _CHANNEL_NAMES[suffix]

        # u[n]: the image index is read back to the host
        if base in ("u", "v") and self.peek() == "[":
            self.next()
            n_expr = self.parse_assign()
            self.expect("]")

            def sub(env, ch=channel):
                n = int(n_expr(env).reshape(-1)[0].item())
                return env.pixel(n, ch)
        elif self.peek() in ("[", "{"):
            opener = self.next()
            dx = self.parse_assign()
            self.expect(",")
            dy = self.parse_assign()
            self.expect("]" if opener == "[" else "}")

            def sub(env, ii=img_idx, ch=channel, absolute=opener == "{"):
                return env.pixel(ii, ch, dx(env), dy(env), absolute)
        else:
            def sub(env, ii=img_idx, ch=channel):
                return env.pixel(ii, ch)

        if suffix == "w":
            return lambda env: env.const(float(env.w))
        if suffix == "h":
            return lambda env: env.const(float(env.h))
        if suffix in ("intensity", "luma"):
            return lambda env, ii=img_idx: _luma(
                env.images[min(ii, len(env.images) - 1)])
        return sub

    def _parse_call(self, fname: str):
        self.expect("(")
        args = []
        if self.peek() != ")":
            args.append(self.parse_assign())
            while self.peek() == ",":
                self.next()
                args.append(self.parse_assign())
        self.expect(")")

        if fname == "rand":
            def rand(env):
                return torch.rand(env.images[0].shape[:-1],
                                  generator=env.generator,
                                  device=env.device)
            return rand

        F = _FUNCTIONS.get(fname)
        if F is None:
            raise ValueError(f"fx: unknown function {fname!r}")
        return lambda env: F(*[a(env) for a in args])


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _or(a, b):
    return _f32((a != 0) | (b != 0))


def _and(a, b):
    return _f32((a != 0) & (b != 0))


def _mod(a, b):
    return a - torch.floor(a / torch.where(b.abs() < 1e-15, 1e-15, b)) * b


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 tensor on ``like``'s device (a true division on
    the card, as on the CPU)."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _safe_log(x, base=None):
    v = torch.log(torch.clamp(x, min=1e-30))
    if base:
        v = v / _c(math.log(base), v)
    return v


def _gcd(a, b):
    """Euclid's gcd of the arguments rounded to integers."""
    a, b = torch.broadcast_tensors(torch.round(a), torch.round(b))
    return torch.gcd(a.to(torch.int64), b.to(torch.int64)).to(torch.float32)


_FUNCTIONS: Dict[str, Callable] = {
    "abs": torch.abs, "acos": torch.acos, "acosh": torch.acosh,
    "asin": torch.asin, "asinh": torch.asinh, "atan": torch.atan,
    "atanh": torch.atanh, "atan2": torch.atan2,
    "ceil": torch.ceil, "clamp": lambda x: torch.clamp(x, 0.0, 1.0),
    "cos": torch.cos, "cosh": torch.cosh,
    "drc": lambda a, b: a / (b * (a - 1.0) + 1.0),
    "erf": torch.erf,
    "exp": torch.exp, "floor": torch.floor,
    "gauss": lambda x: torch.exp(-x * x / _c(2.0, x)) /
    _c(math.sqrt(2.0 * math.pi), x),
    "hypot": torch.hypot, "int": torch.floor,
    "isnan": lambda x: _f32(torch.isnan(x)),
    "ln": lambda x: _safe_log(x),
    "log": lambda x: _safe_log(x, 10.0),
    "logtwo": lambda x: _safe_log(x, 2.0),
    "max": torch.maximum, "min": torch.minimum,
    "mod": _mod,
    "not": lambda x: _f32(x < 1e-15),
    "pow": torch.pow,
    "round": lambda x: torch.floor(x + 0.5),
    "sign": lambda x: torch.where(x < 0, -1.0, 1.0),
    "sin": torch.sin, "sinh": torch.sinh,
    "sinc": torch.sinc,
    "sqrt": lambda x: torch.sqrt(torch.clamp(x, min=0.0)),
    "squish": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "tan": torch.tan, "tanh": torch.tanh,
    "trunc": torch.trunc,
    "alt": lambda x: torch.where(
        torch.remainder(torch.floor(x), 2.0) == 0, 1.0, -1.0),
    "gcd": _gcd,
    "if": lambda c, a, b: torch.where(c != 0, a, b),
    "debug": lambda x: x,
}


def compile_fx(expression: str) -> Callable:
    """Parse an fx expression into ``prog(env) -> tensor`` (host work)."""
    tokens = _tokenize(expression)
    parser = _Parser(tokens)
    prog = parser.parse_program()
    if parser.peek() is not None:
        raise ValueError(f"fx: trailing tokens at {parser.peek()!r}")
    return prog


def fx(images, expression: str,
       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """FxImage (-fx): evaluate per channel over the first image's shape,
    on its device.  ``rand`` draws from ``generator`` (a new one seeded 0
    on the device when None), rewound to its state at the call for each
    channel."""
    if not isinstance(images, (list, tuple)):
        images = [images]
    dev = images[0].device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    state = generator.get_state()
    prog = compile_fx(expression)
    shape = images[0].shape[:-1]
    planes = []
    for ch in range(images[0].shape[-1]):
        generator.set_state(state)
        val = prog(_Env(images, ch, generator, {}))
        planes.append(val.to(torch.float32).expand(shape))
    return torch.stack(planes, dim=-1)
