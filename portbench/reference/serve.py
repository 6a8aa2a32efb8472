"""Plain PyTorch reference of the m3 rollout service's answers, in float32
with TF32 off: the seed clip's tokens, the iterative unmasking of each
generated frame and the decode (minecraft/main2.py:85-131).

A rollout generates ``num_frames`` frames; each starts from a masked last
frame and flat logits and runs ``num_iterations`` unmask steps: a draw of
every position from the logits plus Gumbel noise (a categorical draw),
the positions whose re-mask uniform exceeds alpha = (i + 1) / iterations
(float32) masked again, then the denoiser's logits for the new clip. The
last step (alpha 1) keeps every draw: those are the frame's tokens, which
then join the context (the oldest frame dropped, the generation slot
kept). The noise is the stream the service draws from its generator, per
step a (b, h, w, K) uniform tensor turned into Gumbel noise and a
(b, h, w) re-mask uniform; the reference draws the same stream from the
generator's recorded state.

The program's tokens are judged where they are seen: the encode's output,
the generated frames that come back in the rolled context, and the other
frames through their decoded pixels. Each frame is teacher-forced: it
starts from the program's context. Where the reference's own steps met a
near tie (a kept draw whose two best scores lie within ``tau``), the
program may rightly have drawn otherwise and the frame is not judged; the
request's later frames are then not judged either unless the frame's
tokens are seen.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.reference import m3 as ref_m3
from portbench.reference import tokenizer as ref_tok
from portbench.reference.precision import Precision

TINY = torch.finfo(torch.float32).tiny


def encode_gap(tok, clips: torch.Tensor, prog_tokens: torch.Tensor, downscale: int):
    """The program's codes against the nearest ones: the largest excess
    distance of a chosen code over the nearest, over the mean distance to
    the codebook; and the same with the first code altered (+1), the
    reading of a fault that alters a token where it is made."""
    lat = ref_tok.encoder_latents(tok, clips.reshape(-1, *clips.shape[2:]), downscale)
    flat = lat.reshape(-1, lat.shape[-1]).double()
    e = tok["vq.embedding"][0].double()
    d = (flat * flat).sum(1, keepdim=True) - 2.0 * flat @ e.T + (e * e).sum(1)[None]
    codes = prog_tokens.reshape(-1, 1).long().to(d.device)

    def gap(c):
        return float(((d.gather(1, c)[:, 0] - d.min(1).values) / d.mean(1)).max())

    altered = codes.clone()
    altered[0] = (altered[0] + 1) % e.shape[0]
    return gap(codes), gap(altered)


def _pixel_gap(pix: torch.Tensor, prog: torch.Tensor) -> torch.Tensor:
    """Per row: the largest pixel difference over the reference's largest
    pixel magnitude (a random decoder's pixels are not in [0, 1])."""
    return ((pix - prog).abs().amax((1, 2, 3))
            / pix.abs().amax((1, 2, 3)).clamp_min(1e-12))


class RolloutJudge:
    def __init__(self, cfg: Dict, den: Dict, tok: Dict, device, tau: float):
        self.cfg, self.den, self.tok, self.device, self.tau = cfg, den, tok, device, tau
        sv = cfg["serve"]
        self.frames, self.iters = sv["num_frames"], sv["num_iterations"]
        self.k = cfg["tokenizer"]["num_embeddings"]
        self.down = cfg["tokenizer"]["downscale_steps"]
        grid = cfg["image_size"] // 2 ** self.down
        self.seq = cfg["n_past"] + 1
        self.allowed = ref_m3.window_mask((self.seq, grid, grid), tuple(cfg["extents"]), device)
        self.prec = Precision("f32")

    def logits(self, z: torch.Tensor, tf32: bool = False) -> torch.Tensor:
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            return ref_m3.denoiser_logits(self.den, z, self.cfg, self.prec, self.allowed).float()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved

    @torch.no_grad()
    def judge(self, rec: Dict, rows: torch.Tensor) -> Dict:
        """Judge ``rows`` of one recorded rollout call (``tokens`` in,
        generator ``state`` before it, ``context`` and ``pixels`` out)."""
        dev, k, s, t_all = self.device, self.k, self.seq, self.frames
        gen = torch.Generator(device=dev)
        gen.set_state(rec["state"])
        b, _, h, w = rec["tokens"].shape
        rows = rows.to(dev)
        ctx = rec["tokens"].to(dev)[rows].long()
        context = rec["context"].to(dev)[rows].long()
        pixels = rec["pixels"].to(dev)[rows]
        seen_from = t_all - (s - 1)  # frames at and past this come back in the context
        alive = torch.ones(len(rows), dtype=torch.bool, device=dev)
        out = {"draw_gap": 0.0, "control_gap": 0.0, "pixel_gap": 0.0, "judged": 0,
               "frames": len(rows) * t_all, "fault_draw_gap": math.inf,
               "fault_pixel_gap": math.inf}
        for t in range(t_all):
            z = ctx.clone()
            z[:, -1] = k
            logits = torch.zeros((len(rows), h, w, k), device=dev)
            margin = torch.full((len(rows),), math.inf, device=dev)
            for i in range(self.iters):
                u = torch.rand((b, h, w, k), generator=gen, device=dev)[rows]
                gumbel = -torch.log(-torch.log(u.clamp_min(TINY)))
                remask = torch.rand((b, h, w), generator=gen, device=dev)[rows]
                alpha = float(np.float32(i + 1) / np.float32(self.iters))
                score = logits + gumbel
                top = score.topk(2, dim=-1).values
                draw = score.argmax(-1)
                if i == self.iters - 1:
                    break
                kept = remask <= alpha
                gap2 = torch.where(kept, top[..., 0] - top[..., 1], math.inf)
                margin = torch.minimum(margin, gap2.amin((1, 2)))
                z[:, -1] = torch.where(remask > alpha, k, draw)
                logits = self.logits(z)
                if i == self.iters - 2:
                    control_logits = self.logits(z, tf32=True)
            control = (control_logits + gumbel).argmax(-1)
            best = score.max(-1).values
            sure = margin >= self.tau
            if t >= seen_from:
                prog = context[:, t - seen_from]
                gap = (best - score.gather(-1, prog[..., None])[..., 0]).amax((1, 2))
                judged = alive & (sure | (gap <= self.tau))
            else:  # the program's tokens only through its pixels
                pix = ref_tok.decode(self.tok, draw, self.down)
                same = _pixel_gap(pix, pixels[:, t]) <= self.tau_pixels
                prog = draw
                gap = torch.where(same, 0.0, math.inf)
                final_sure = (top[..., 0] - top[..., 1]).amin((1, 2)) >= self.tau
                judged = alive & (same | (sure & final_sure))
            ctl = (best - score.gather(-1, control[..., None])[..., 0]).amax((1, 2))
            if judged.any():
                out["draw_gap"] = max(out["draw_gap"], float(gap[judged].max()))
                out["control_gap"] = max(out["control_gap"], float(ctl[judged].max()))
                pix = ref_tok.decode(self.tok, prog, self.down)
                diff = _pixel_gap(pix, pixels[:, t])
                ok_pix = judged & (gap <= self.tau)
                if ok_pix.any():
                    out["pixel_gap"] = max(out["pixel_gap"], float(diff[ok_pix].max()))
                # the fault of a token altered where it is made: the first
                # position's token + 1, its score gap and its pixels
                bad = prog.clone()
                bad[:, 0, 0] = (bad[:, 0, 0] + 1) % k
                bad_gap = (best - score.gather(-1, bad[..., None])[..., 0]).amax((1, 2))
                bad_pix = _pixel_gap(ref_tok.decode(self.tok, bad, self.down), pix)
                out["fault_draw_gap"] = min(out["fault_draw_gap"], float(bad_gap[judged].min()))
                out["fault_pixel_gap"] = min(out["fault_pixel_gap"], float(bad_pix[judged].min()))
                out["judged"] += int(judged.sum())
            alive = judged & (gap <= self.tau) if t < seen_from else alive
            ctx = torch.cat([ctx[:, 1:-1], prog[:, None], ctx[:, -1:]], dim=1)
        return out

    tau_pixels = 0.01  # of the largest pixel: 7x TF32 convolutions' noise, 1/14 of a token's change
