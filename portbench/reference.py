"""The plain reference: Whisper training steps and teacher-forced logits in
fp32 PyTorch, with TF32 off.

It imports nothing of the program. Every law the program's timed path
follows is written out again here from its description: the log-mel
frontend, SpecAugment's masks and lora dropout's masks (drawn from the
same seeded streams, so both sides mask the same positions), the int8
base with its calibrated outlier columns and the W8A8 product, the
low-rank adapters, AdaLoRA's orthogonality penalty, the clipped AdamW
update. It works them out from the inputs the benchmark made (weights.py,
traffic.py), never from what the program made.

`lower=True` is the control: every product the configuration states in
bf16 takes its operands rounded to fp8 (e4m3, one scale a tensor; their
gradients e5m2), every int8 product its operands to int4, the next
precision down. The conv
stem, the layer norms and the log-mel stay fp32, as the configuration
states them.

Memory: each layer runs under torch.utils.checkpoint in training, and the
teacher-forced logits are made in blocks of rows, so a cell's batch fits
beside nothing else on the card once the program has been freed.
"""
from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import weights as WT

SAMPLE_RATE, N_FFT, HOP, FRAMES = 16_000, 400, 160, 3000
CHUNK = 30 * SAMPLE_RATE
INV_127 = float(np.float32(1.0) / np.float32(127.0))
IGNORE = -100


def fp32_mode() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------------- frontend

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) * 27.0 / np.log(6.4),
                    3.0 * f / 200.0)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), 200.0 * m / 3.0)


def mel_filters(n_mels: int) -> np.ndarray:
    """Slaney-scale, slaney-normalised triangles over 0-8 kHz, (201, n_mels)."""
    freqs = np.linspace(0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(8000.0), n_mels + 2))
    fdiff = np.diff(pts)
    slopes = pts[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / fdiff[None, :-1],
                                    slopes[:, 2:] / fdiff[None, 1:]))
    return fb * (2.0 / (pts[2:n_mels + 2] - pts[:n_mels]))[None, :]


def pad_audio(clips: Sequence[np.ndarray], device) -> torch.Tensor:
    """(B, 480000) fp32: each clip zero-padded or cut to the 30 s window."""
    out = np.zeros((len(clips), CHUNK), np.float32)
    for i, c in enumerate(clips):
        n = min(len(c), CHUNK)
        out[i, :n] = c[:n]
    return torch.from_numpy(out).to(device)


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, 480000) → (B, 3000, n_mels): reflect-padded periodic-hann STFT of
    400 at hop 160, power, mel, log10 floored at 1e-10, the utterance's
    (max - 8) floor, (x + 4) / 4."""
    x = F.pad(audio.float()[:, None, :], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)[:, :FRAMES]
    n = torch.arange(N_FFT, device=audio.device, dtype=torch.float64)
    win = (0.5 - 0.5 * torch.cos(2 * math.pi * n / N_FFT)).float()
    power = torch.fft.rfft(frames * win, dim=-1).abs().square()
    fb = torch.from_numpy(mel_filters(n_mels).astype(np.float32)).to(audio.device)
    lg = torch.log10(torch.clamp(power @ fb, min=1e-10))
    lg = torch.maximum(lg, lg.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (lg + 4.0) / 4.0


# ------------------------------------------------------- seeded mask streams

def stream_generator(seed: int, step: int, site: str, device) -> torch.Generator:
    """The generator of (seed, step, site): a blake2b digest of the three."""
    digest = hashlib.blake2b(f"{seed}/{step}/{site}".encode(), digest_size=8).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest, "little") >> 1)
    return g


def _spans(g, batch, length, max_w, n):
    widths = torch.randint(0, max_w + 1, (batch, n), generator=g, device=g.device)
    high = torch.clamp(length - widths, min=1)
    u = torch.rand((batch, n), generator=g, device=g.device, dtype=torch.float64)
    starts = torch.floor(u * high).long()
    pos = torch.arange(length, device=g.device)[None, None, :]
    return ((pos >= starts[..., None]) & (pos < (starts + widths)[..., None])).any(dim=1)


def spec_augment(mel: torch.Tensor, seed: int, step: int) -> torch.Tensor:
    """LibriSpeech LD policy: 2 frequency masks up to 27 bins, then 2 time
    masks up to 100 frames, filled with the utterance's mean."""
    B, T, Fm = mel.shape
    g = stream_generator(seed, step, "spec_augment", mel.device)
    fmask = _spans(g, B, Fm, min(27, Fm), 2)
    tmask = _spans(g, B, T, min(100, T), 2)
    fill = mel.mean(dim=(1, 2), keepdim=True)
    return torch.where(fmask[:, None, :] | tmask[:, :, None], fill, mel)


# ------------------------------------------------------------------ products

def _round(t: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    s = t.abs().amax().clamp(min=1e-30) / fmax
    return (t / s).to(dtype).float() * s


class _Fp8(torch.autograd.Function):
    """An operand rounded to fp8 with one scale a tensor: e4m3 in the
    forward, its gradient e5m2 in the backward (the FP8 training recipe)."""

    @staticmethod
    def forward(ctx, t):
        return _round(t.detach(), torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def _round_int4(t: torch.Tensor, dim: int) -> torch.Tensor:
    s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 7.0
    return torch.clamp(torch.round(t / s), -7, 7) * s


class Precision:
    """How the products are computed: fp32 (the reference) or one step below
    the configuration's precision (the control)."""

    def __init__(self, lower: bool = False):
        self.lower = lower

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A product the configuration states in bf16."""
        if self.lower:
            a, b = _Fp8.apply(a), _Fp8.apply(b)
        return torch.matmul(a, b)


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per output channel symmetric int8 of (..., d_in, d_out): (the int8
    values as fp32, the fp32 scales (..., 1, d_out))."""
    scale = torch.clamp(w.abs().amax(dim=-2, keepdim=True), min=1e-8) / 127.0
    return torch.clamp(torch.round(w / scale), -127, 127), scale


class _W8A8(torch.autograd.Function):
    """LLM.int8()'s product: the outlier columns of x times the dequantized
    weight rows in fp32, the rest of x quantized per row to int8 (scale
    amax * f32(1/127), round half to even) times the int8 weight; the
    backward straight through the dequantized weight."""

    @staticmethod
    def forward(ctx, x, wq, ws, idx, lower):
        wd = wq * ws
        ctx.save_for_backward(wd)
        keep = torch.ones(x.shape[-1], device=x.device)
        addend = 0.0
        if idx is not None and idx.numel():
            keep[idx] = 0.0
            addend = torch.matmul(x[..., idx], wd[idx])
        xk = x * keep
        xs = torch.clamp(xk.abs().amax(dim=-1, keepdim=True), min=1e-8) * INV_127
        x8 = torch.clamp(torch.round(xk / xs), -127, 127)
        w8 = wq
        if lower:
            x8 = torch.clamp(torch.round(x8 / 127.0 * 7.0), -7, 7) * (127.0 / 7.0)
            w8 = _round_int4(wq, -2)
        return torch.matmul(x8, w8) * xs * ws + addend

    @staticmethod
    def backward(ctx, dy):
        (wd,) = ctx.saved_tensors
        return torch.matmul(dy, wd.t()), None, None, None, None


class Quant:
    """The int8 base: values and scales of every stacked projection, and the
    outlier columns per (d_in, d_out) class: calibrated sets, or (while
    calibrating) the dynamic top-k form with the column amax recorded."""

    def __init__(self, weights: Dict[str, Any], k: int):
        self.k = k
        self.q: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.sets: Optional[Dict[Tuple[int, int], torch.Tensor]] = None
        self.record: Optional[Dict[Tuple[int, int], torch.Tensor]] = None
        for _, p in _projections(weights):
            self.q[id(p["w"])] = quantize_int8(p["w"])

    def product(self, x: torch.Tensor, w: torch.Tensor, layer: int,
                prec: Precision) -> torch.Tensor:
        wq, ws = self.q[id(w)]
        wq, ws = wq[layer], ws[layer]
        klass = tuple(wq.shape)
        x2 = x.reshape(-1, klass[0])
        if self.record is not None:
            a = x2.detach().abs().amax(dim=0)
            cur = self.record.get(klass)
            self.record[klass] = a if cur is None else torch.maximum(cur, a)
        if self.sets is not None:
            idx = self.sets.get(klass)
        elif self.k > 0:
            idx = torch.topk(x2.detach().abs().amax(dim=0), min(self.k, klass[0])).indices
        else:
            idx = None
        y = _W8A8.apply(x2, wq, ws.reshape(1, -1), idx, prec.lower)
        return y.reshape(*x.shape[:-1], klass[1])

    def calibrate(self, run, threshold: float, max_cols: int) -> None:
        """Install as the sets every column whose amax over run() reaches
        threshold, the largest max_cols of a class."""
        self.record, self.sets = {}, None
        try:
            with torch.no_grad():
                run()
            sets = {}
            for klass, amax in self.record.items():
                a = amax.cpu().numpy()
                cols = np.where(a >= threshold)[0]
                if max_cols and cols.size > max_cols:
                    cols = cols[np.argsort(a[cols])[::-1][:max_cols]]
                sets[klass] = torch.as_tensor(np.sort(cols), dtype=torch.long,
                                              device=amax.device)
        finally:
            self.record = None
        self.sets = sets

    def sets_as_tuples(self) -> Dict[Tuple[int, int], Tuple[int, ...]]:
        return {k: tuple(int(i) for i in v.cpu()) for k, v in (self.sets or {}).items()}


def _projections(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            if "w" in v and k in ("q", "k", "v", "o", "fc1", "fc2"):
                yield f"{prefix}/{k}", v
            else:
                yield from _projections(v, f"{prefix}/{k}")


# --------------------------------------------------------------------- model

class Model:
    """The forward of the port's tree, every layer l read from the stacked
    leaves. `quant`: the int8 base's products (else the fp32 weights);
    `adapters`: q/v low-rank deltas with lora dropout at `dropout` rate from
    the (seed, step) streams."""

    def __init__(self, cfg: Dict[str, Any], weights: Dict[str, Any],
                 prec: Precision, quant: Optional[Quant] = None,
                 adapters: Optional[Dict[str, Any]] = None, dropout: float = 0.0,
                 remat: bool = False):
        self.n = WT.dims(cfg)
        self.w, self.prec, self.quant = weights, prec, quant
        self.adapters, self.rate, self.remat = adapters, dropout, remat
        self.seed = self.step = None       # the dropout stream, set per step

    # -- pieces
    def _ln(self, x, p, l=None):
        s, b = (p["scale"], p["bias"]) if l is None else (p["scale"][l], p["bias"][l])
        return F.layer_norm(x, (x.shape[-1],), s, b, eps=1e-5)

    def _drop(self, x, site):
        if self.rate <= 0 or self.seed is None:
            return x
        g = stream_generator(self.seed, self.step, site, x.device)
        u = torch.rand(x.shape, generator=g, device=x.device)
        return torch.where(u >= self.rate, x / (1.0 - self.rate), torch.zeros_like(x))

    def _proj(self, x, p, l, ad=None, site=""):
        if self.quant is not None:
            y = self.quant.product(x, p["w"], l, self.prec)
        else:
            y = self.prec.mm(x, p["w"][l])
        if ad is not None:
            xa = self._drop(x, site)
            t = self.prec.mm(xa, ad["a"][l]) * ad["e"][l]
            y = y + self.prec.mm(t, ad["b"][l]) * ad["scaling"][l]
        if "b" in p:
            y = y + p["b"][l]
        return y

    def _attend(self, q, k, v, heads, causal):
        B, Tq, d = q.shape
        hd = d // heads
        qh = q.reshape(B, Tq, heads, hd).transpose(1, 2)
        kh = k.reshape(B, -1, heads, hd).transpose(1, 2)
        vh = v.reshape(B, -1, heads, hd).transpose(1, 2)
        s = self.prec.mm(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
        if causal:
            Tk = kh.shape[2]
            s = s.masked_fill(torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
                              .triu(1), float("-inf"))
        o = self.prec.mm(torch.softmax(s, dim=-1), vh)
        return o.transpose(1, 2).reshape(B, Tq, d)

    def _attn(self, h, p, l, heads, ad, site, kv=None, causal=False):
        src = h if kv is None else kv
        q = self._proj(h, p["q"], l, ad.get("q") if ad else None, f"{site}/q")
        k = self._proj(src, p["k"], l)
        v = self._proj(src, p["v"], l, ad.get("v") if ad else None, f"{site}/v")
        return self._proj(self._attend(q, k, v, heads, causal), p["o"], l)

    def _mlp(self, h, p, l):
        return self._proj(F.gelu(self._proj(h, p["fc1"], l)), p["fc2"], l)

    def _run(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # -- stacks
    def _enc_layer(self, x, l):
        lp = self.w["encoder"]["layers"]
        ad = self.adapters.get("encoder") if self.adapters else None
        x = x + self._attn(self._ln(x, lp["ln1"], l), lp["attn"], l, self.n["H_e"], ad,
                           f"enc/{l}")
        return x + self._mlp(self._ln(x, lp["ln2"], l), lp["mlp"], l)

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        enc = self.w["encoder"]
        x = F.gelu(F.conv1d(mel.transpose(1, 2), enc["conv1"]["w"].permute(2, 1, 0),
                            enc["conv1"]["b"], padding=1))
        x = F.gelu(F.conv1d(x, enc["conv2"]["w"].permute(2, 1, 0), enc["conv2"]["b"],
                            stride=2, padding=1)).transpose(1, 2)
        x = x + self.w["encoder_pos"][: x.shape[1]][None]
        for l in range(self.n["L_e"]):
            x = self._run(self._enc_layer, x, l)
        return self._ln(x, enc["ln_post"])

    def _dec_layer(self, x, enc_out, l):
        lp = self.w["decoder"]["layers"]
        ad = self.adapters["decoder"] if self.adapters else {}
        H = self.n["H_d"]
        x = x + self._attn(self._ln(x, lp["ln1"], l), lp["self_attn"], l, H,
                           ad.get("self_attn"), f"dec/{l}/self", causal=True)
        x = x + self._attn(self._ln(x, lp["ln2"], l), lp["cross_attn"], l, H,
                           ad.get("cross_attn"), f"dec/{l}/cross", kv=enc_out)
        return x + self._mlp(self._ln(x, lp["ln3"], l), lp["mlp"], l)

    def decode(self, tokens: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        """Hidden states after the final layer norm, (B, T, d)."""
        dec = self.w["decoder"]
        x = dec["embed"][tokens] + dec["pos"][: tokens.shape[1]][None]
        for l in range(self.n["L_d"]):
            x = self._run(self._dec_layer, x, enc_out, l)
        return self._ln(x, dec["ln_post"])

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return self.prec.mm(h, self.w["decoder"]["embed"].t())

    def loss(self, mel: torch.Tensor, dec_in: torch.Tensor, labels: torch.Tensor
             ) -> torch.Tensor:
        """Mean cross-entropy over the labels that are not IGNORE, the logits
        made 256 rows at a time."""
        h = self.decode(dec_in, self.encode(mel))
        h2, lab = h.reshape(-1, h.shape[-1]), labels.reshape(-1)
        mask = lab != IGNORE
        safe = torch.where(mask, lab, torch.zeros_like(lab))
        total = h2.new_zeros(())
        for a in range(0, h2.shape[0], 256):
            lg = self.logits(h2[a:a + 256])
            nll = torch.logsumexp(lg, -1) - lg.gather(-1, safe[a:a + 256, None])[:, 0]
            total = total + torch.where(mask[a:a + 256], nll, torch.zeros_like(nll)).sum()
        return total / mask.sum().clamp(min=1)


def orth_penalty(adapters: Dict[str, Any], weight: float) -> torch.Tensor:
    """weight * mean over layers and the two factors of ||A^T A - I||^2 and
    ||B B^T - I||^2."""
    total, count = 0.0, 0
    for path, a in WT.leaves(adapters):
        if not path.endswith("/a"):
            continue
        b = _at(adapters, path[:-2] + "/b")
        eye = torch.eye(a.shape[-1], device=a.device)
        total = total + ((a.transpose(1, 2) @ a - eye) ** 2).sum() \
            + ((b @ b.transpose(1, 2) - eye) ** 2).sum()
        count += a.shape[0] * 2
    return weight * total / count


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


# ------------------------------------------------------------------ training

def labels_of(text: str, prefix: Sequence[int], eot: int, bucket: int):
    """(decoder input, labels) of one utterance: the byte tokens of text
    after the prefix without its leading sot, then eot, padded with eot
    (inputs, after sot) and IGNORE (labels) to the bucket."""
    lab = list(prefix[1:]) + list(text.encode("utf-8")) + [eot]
    lab = lab[:bucket]
    dec = [prefix[0]] + lab[: bucket - 1]
    return (dec + [eot] * (bucket - len(dec)), lab + [IGNORE] * (bucket - len(lab)))


BUCKETS = (48, 96, 192, 448)


def bucket_of(texts: Sequence[str], prefix: Sequence[int]) -> int:
    """The padded label length of a batch: the smallest bucket that holds
    its longest label (the prefix without sot, the text's bytes, eot)."""
    longest = max(len(prefix) + len(t.encode("utf-8")) for t in texts)
    return next((b for b in BUCKETS if longest <= b), BUCKETS[-1])


def batch_tensors(pool, rows: Sequence[int], prefix, eot, n_mels, device):
    audio = pad_audio([pool.audio(i) for i in rows], device)
    bucket = bucket_of([pool.texts[i] for i in rows], prefix)
    pairs = [labels_of(pool.texts[i], prefix, eot, bucket) for i in rows]
    dec = torch.tensor([p[0] for p in pairs], device=device)
    lab = torch.tensor([p[1] for p in pairs], device=device)
    return log_mel(audio, n_mels), dec, lab


def train_steps(cfg: Dict[str, Any], opts: Dict[str, Any], seed: int, pool,
                step_rows: List[Sequence[int]], calib_pool, device,
                lower: bool = False, half_batch: bool = False) -> Dict[str, Any]:
    """The cell's first len(step_rows) training steps from the seed's
    weights: each step's loss, the first gradient's norm per trained leaf as
    the optimizer takes it (clipped), each step's gradient norm per leaf
    before clipping, and the norm of each trained leaf's change over the
    steps. opts: the cell's training settings (traffic file). half_batch:
    the fault of a step that leaves out half of its rows."""
    fp32_mode()
    peft = opts["mode"] == "peft"
    weights = WT.make_weights(cfg, seed, device)
    prec = Precision(lower)
    adapters = quant = None
    if peft:
        adapters = WT.make_adapters(cfg, opts["lora_rank"], opts["lora_alpha"], seed,
                                    device, encoder=opts["encoder_adapters"])
        if opts.get("int8"):
            quant = Quant(weights, opts["outlier_cols"])
    prefix, eot = opts["prefix"], opts["eot"]
    n_mels = int(cfg["num_mel_bins"])
    model = Model(cfg, weights, prec, quant, adapters,
                  dropout=opts.get("lora_dropout", 0.0) if peft else 0.0, remat=True)
    out: Dict[str, Any] = {}
    if quant is not None and opts.get("calibrate"):
        mel, dec, lab = batch_tensors(calib_pool, range(4), prefix, eot, n_mels,
                                      device)
        quant.calibrate(lambda: model.loss(mel, dec, lab), opts["outlier_threshold"],
                        2 * opts["outlier_cols"])
        out["outlier_sets"] = quant.sets_as_tuples()
    tree = adapters if peft else weights
    named = WT.leaves(tree)
    trained = [(k, p) for k, p in named
               if not peft or k.endswith("/a") or k.endswith("/b")
               or (k.endswith("/e") and opts.get("adalora"))]
    for _, p in named:
        p.requires_grad_(True)
    start = [p.detach().clone() for _, p in trained]
    mu = [torch.zeros_like(p) for _, p in trained]
    nu = [torch.zeros_like(p) for _, p in trained]
    b1, b2, eps, wd = 0.9, 0.98, 1e-8, opts["weight_decay"]
    losses, raw_norms = [], []
    for s, rows in enumerate(step_rows):
        rows = list(rows)[: len(rows) // 2] if half_batch else rows
        mel, dec, lab = batch_tensors(pool, rows, prefix, eot, n_mels, device)
        if opts.get("spec_augment"):
            mel = spec_augment(mel, opts["seed"], s)
        model.seed, model.step = opts["seed"], s
        loss = model.loss(mel, dec, lab)
        total = loss
        if peft and opts.get("adalora"):
            total = loss + orth_penalty(adapters, opts["orth_reg_weight"])
        for _, p in named:
            p.grad = None
        total.backward()
        losses.append(float(loss.detach()))
        grads = [p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
                 for _, p in trained]
        raw_norms.append([float(g.norm()) for g in grads])
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
        if float(gnorm) >= opts["max_grad_norm"]:
            grads = [g / gnorm * opts["max_grad_norm"] for g in grads]
        if s == 0:
            out["first_grad"] = [float(g.norm()) for g in grads]
        lr = opts["lr"] * (1 - min(s, opts["max_steps"]) / opts["max_steps"])
        with torch.no_grad():
            for (_, p), g, m, v in zip(trained, grads, mu, nu):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m / (1 - b1 ** (s + 1))) / ((v / (1 - b2 ** (s + 1))).sqrt() + eps)
                if wd:
                    upd = upd + wd * p
                p.add_(upd, alpha=-lr)
        del loss, total, grads, mel
    out.update(names=[k for k, _ in trained], losses=losses, raw_grad=raw_norms,
               change=[float((p.detach() - p0).norm()) for (_, p), p0 in zip(trained, start)])
    return out


# ------------------------------------------------------------------- serving

@torch.no_grad()
def served_gaps(cfg: Dict[str, Any], seed: int, clips: Sequence[np.ndarray],
                tokens: Sequence[Sequence[int]], n_forced: int, eot: int, device,
                lower: bool = False, law: Optional[Dict[str, float]] = None) -> List[float]:
    """For each served utterance, the widest gap by which the logit of a
    served token lies below the best logit at its position, the model run
    teacher-forced over the prompt and the served tokens (up to the first
    eot). lower (the control): at each of those positions the token that
    the model one precision down puts first is read instead. law: the
    traffic's weight law (weights.make_weights)."""
    fp32_mode()
    n = WT.dims(cfg)
    weights = WT.make_weights(cfg, seed, device, law)
    model = Model(cfg, weights, Precision())
    low = Model(cfg, weights, Precision(True)) if lower else None
    out = []
    for clip, toks in zip(clips, tokens):
        toks = list(toks)
        end = len(toks)
        for j in range(n_forced, len(toks)):
            if toks[j] == eot:
                end = j + 1
                break
        mel = log_mel(pad_audio([clip], device), n["mels"])
        t = torch.tensor([toks[: end - 1]], device=device)
        rows = model.logits(model.decode(t, model.encode(mel)))[0][n_forced - 1:]
        if low is None:
            picked = torch.tensor(toks[n_forced:end], device=device)
        else:
            picked = low.logits(low.decode(t, low.encode(mel)))[0][n_forced - 1:].argmax(-1)
        gap = rows.amax(dim=-1) - rows.gather(-1, picked[:, None])[:, 0]
        out.append(float(gap.max()) if gap.numel() else 0.0)
    return out
