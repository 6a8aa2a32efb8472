"""Exported serving artifacts, served as CUDA graphs.

Port of ``world_modelz_tpu.aot``: the rollout service's two programs, the
seed-clip ENCODE (pixels -> token context) and the ROLLOUT (iterative
unmask over ``num_frames`` frames -> decode to pixels and the rolled
context), at every size of the batch ladder, beside one copy of the
weights:

    artifact/
      meta.json     frames, iterations, top-k, ladder sizes, shapes, the
                    denoiser's and the tokenizer's constructor arguments
      weights.npz   both state_dicts, one copy, path-flattened as the JAX
                    artifact's ("params//<key>", "tok//<key>")

A CUDA graph cannot be serialized, so the artifact holds everything but
the programs. ``AOTPrograms.load`` rebuilds the two modules from it (f32,
eval mode, the denoiser's attention ``backend="auto"``) and, on the GPU,
captures each ladder size's programs as CUDA graphs
(``train.dispatch.capture``: warmed up on a side stream first, so the
kernels' first-use attribute and occupancy calls stay out of the capture):

- ``encode``: the encoder convs and the ``vq_encode`` kernel;
- ``step``: one unmask step, the draw from the previous logits and the
  re-mask (``diffusion/masked.py:draw_last_frame``, alpha read from a 0-d
  f32 buffer), then the denoiser's forward (one ``local3d_fwd`` a layer);
  ``step_topk`` the same with top-k, for the steps from iteration 1 on
  when ``sample_topk > 0``. Replayed ``num_iterations`` times a frame;
- ``finish``: the tokenizer's decode of the generated frames and the
  rolled context.

Between replays the host draws the step's Gumbel and re-mask uniforms
from the caller's ``torch.Generator`` in ``generator_noise``'s order and
copies them into the step's static inputs, and moves the context on a
frame. So a live ``RolloutService`` and one built on ``AOTPrograms`` with
the same seed give the same clips, tokens and pixels bit for bit (as the
JAX artifact promises, aot.py:22-24), and ``rollout(noise=...)`` takes
the draws of a test as ``rollout_frames`` does. On the CPU
(``device="cpu"``) the same program functions run, uncaptured.

A replay passes no kernel wrapper, so ``_build.LAUNCHES`` and the launch
log see only the capture. Each graph keeps the wrapper counts and the
kernel names noted while it was captured; each replay adds them to
``launches`` and ``kernel_launches``.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from world_modelz_tpu_torch._device import DeviceLike, resolve_device
from world_modelz_tpu_torch.diffusion.masked import (
    Noise,
    draw_last_frame,
    generator_noise,
    shift_context,
    unmask_alpha,
)
from world_modelz_tpu_torch.kernels import _build
from world_modelz_tpu_torch.models.tokenizer import VQAutoEncoder
from world_modelz_tpu_torch.models.video import VqVideoDiffusionModel
from world_modelz_tpu_torch.serve import ladder, rolled_context
from world_modelz_tpu_torch.train.dispatch import capture
from world_modelz_tpu_torch.utils import tracing

FORMAT = 1
_META = "meta.json"
_WEIGHTS = "weights.npz"
# npz key separator; state_dict keys never contain it
_SEP = "//"
# the sampler's default: top-k applies from iteration 1 on (main2.py:97-98)
TOPK_FROM_ITERATION = 1


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    else:
        out[prefix[: -len(_SEP)]] = tree.detach().cpu().numpy()
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


def export_service(
    out_dir: str,
    tok: VQAutoEncoder,
    model: VqVideoDiffusionModel,
    *,
    num_frames: int,
    num_iterations: int = 30,
    sample_topk: int = -1,
    batch_size: int = 8,
    seed_frames: int,
    image_size: int,
    channels: int,
) -> Dict[str, Any]:
    """Write the artifact of the service's programs at every ladder size:
    the weights and what ``AOTPrograms.load`` needs to rebuild and capture
    them. The denoiser must be f32 with the attention ``backend="auto"``
    (or ``"pallas"``): a fused model (``backend="fused"``, a cooperative
    launch) raises, as do other dtypes. Returns the metadata."""
    if model.config["backend"] == "fused":
        raise ValueError(
            "export_service serves the unfused attention (backend='auto'); "
            "a fused denoiser (backend='fused') cannot be exported")
    dtypes = {t.dtype for t in model.state_dict().values() if t.is_floating_point()}
    if dtypes != {torch.float32}:
        raise ValueError(f"export_service serves an f32 denoiser, got {dtypes}")
    th, tw = tok.token_grid_shape((image_size, image_size))
    if tuple(model.config["data_shape"]) != (seed_frames, th, tw):
        raise ValueError(
            f"the denoiser's token grid {model.config['data_shape']} is not "
            f"({seed_frames}, {th}, {tw}) of {seed_frames} frames of "
            f"{image_size}x{image_size}")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, _WEIGHTS), **_flatten(
        {"params": model.state_dict(), "tok": tok.state_dict()}))
    meta = {
        "format": FORMAT,
        "num_frames": int(num_frames),
        "num_iterations": int(num_iterations),
        "sample_topk": int(sample_topk),
        "sizes": ladder(batch_size),
        "seed_frames": int(seed_frames),
        "image_size": int(image_size),
        "channels": int(channels),
        "token_hw": [th, tw],
        "num_embeddings": tok.num_embeddings,
        "denoiser": dict(model.config, backend="auto"),
        "tokenizer": dict(tok.config),
        "torch_version": torch.__version__,
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class _SizePrograms:
    """One ladder size's static buffers and program functions. The
    functions read and write only these buffers (and return their
    outputs), so a captured graph replays them as they are."""

    def __init__(self, progs: "AOTPrograms", b: int):
        meta, dev = progs.meta, progs.device
        self.tok, self.model = progs.tok, progs.model
        s, img, c = meta["seed_frames"], meta["image_size"], meta["channels"]
        th, tw = meta["token_hw"]
        k = meta["num_embeddings"]

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.seeds = zeros(b, s, img, img, c)
        self.tokens = zeros(b, s, th, tw, dtype=torch.long)  # rollout input
        self.context = zeros(b, s, th, tw, dtype=torch.long)
        self.z = zeros(b, s, th, tw, dtype=torch.long)
        self.logits = zeros(b, th, tw, k)
        self.gumbel = zeros(b, th, tw, k)
        self.uniform = zeros(b, th, tw)
        self.alpha = zeros()  # 0-d f32: a captured step reads it on the card
        self.gen = zeros(b, meta["num_frames"], th, tw, dtype=torch.long)
        self.mask_token = k
        self.sample_topk = meta["sample_topk"]
        self.fns: Dict[str, Callable[[], Tuple[torch.Tensor, ...]]] = {
            "encode": self.encode, "step": lambda: self.step(-1),
            "finish": self.finish,
        }
        if self.sample_topk > 0 and meta["num_iterations"] > TOPK_FROM_ITERATION:
            self.fns["step_topk"] = lambda: self.step(self.sample_topk)

    def encode(self) -> Tuple[torch.Tensor, ...]:
        b, s = self.seeds.shape[:2]
        tokens = self.tok.encode(self.seeds.reshape(b * s, *self.seeds.shape[2:]))
        return (tokens.reshape(b, s, *tokens.shape[1:]),)

    def step(self, sample_topk: int) -> Tuple[torch.Tensor, ...]:
        self.z[:, -1] = draw_last_frame(
            self.logits, self.gumbel, self.uniform, self.alpha,
            mask_token=self.mask_token, sample_topk=sample_topk)
        # f32 (the model is), as unmask_frame takes the logits
        self.logits.copy_(self.model(self.z).float())
        return ()

    def finish(self) -> Tuple[torch.Tensor, ...]:
        b, t = self.gen.shape[:2]
        pixels = self.tok.decode(self.gen.reshape(b * t, *self.gen.shape[2:]))
        return (pixels.reshape(b, t, *pixels.shape[1:]),
                rolled_context(self.tokens, self.gen))


class AOTPrograms:
    """A loaded serving artifact: encode and rollout at each ladder size,
    captured as CUDA graphs on the GPU (run uncaptured on the CPU).

    Attributes:
      meta: the artifact's metadata; ``sizes`` its ladder.
      device: where the programs run.
      capture_seconds: ladder size -> seconds its warm-up and captures took.
      captured: (program, size) -> (wrapper counts, kernel names) noted
        while the graph was captured.
      launches, kernel_launches: ``collections.Counter`` of the kernel
        launches the replays made, by wrapper (``local3d_fwd``,
        ``vq_encode``) and by kernel name (``name<args>``): each replay
        adds its graph's captured counts. Clear them to count a window.
    """

    @torch.inference_mode()
    def __init__(self, meta: Dict[str, Any], tok: VQAutoEncoder,
                 model: VqVideoDiffusionModel, device: torch.device):
        self.meta = meta
        self.sizes: List[int] = list(meta["sizes"])
        self.device = device
        self.tok, self.model = tok, model
        self.capture_seconds: Dict[int, float] = {}
        self.captured: Dict[Tuple[str, int], Tuple[collections.Counter, collections.Counter]] = {}
        self.launches: "collections.Counter[str]" = collections.Counter()
        self.kernel_launches: "collections.Counter[str]" = collections.Counter()
        self._lock = threading.Lock()  # one call at a time: static buffers
        self._graphs: Dict[Tuple[str, int], torch.cuda.CUDAGraph] = {}
        self._outputs: Dict[Tuple[str, int], Tuple[torch.Tensor, ...]] = {}
        self._programs = {b: _SizePrograms(self, b) for b in self.sizes}

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "AOTPrograms":
        """Rebuild the modules of the artifact at ``path`` and, on the GPU,
        capture every ladder size's programs. ``device=None`` means CUDA
        (raises without a GPU); ``"cpu"`` runs the programs uncaptured."""
        dev = resolve_device(device)
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        if meta.get("format") != FORMAT:
            raise ValueError(f"unknown artifact format {meta.get('format')}")
        with np.load(os.path.join(path, _WEIGHTS)) as npz:
            tree = _unflatten({k: npz[k] for k in npz.files})

        def state(name):
            return {k: torch.from_numpy(v) for k, v in tree[name].items()}

        tok = VQAutoEncoder(**meta["tokenizer"], device=dev)
        tok.load_state_dict(state("tok"), strict=True)
        den = dict(meta["denoiser"], backend="auto")
        den["data_shape"], den["extents"] = (
            tuple(den["data_shape"]), tuple(den["extents"]))
        model = VqVideoDiffusionModel(**den, device=dev)
        model.load_state_dict(state("params"), strict=True)
        progs = cls(meta, tok.eval(), model.eval(), dev)
        if dev.type == "cuda":
            for b in progs.sizes:
                t0 = time.perf_counter()
                for name in progs._programs[b].fns:
                    progs._capture(name, b)
                progs.capture_seconds[b] = time.perf_counter() - t0
        return progs

    # ----------------------------------------------------------- programs

    @torch.inference_mode()
    def _capture(self, name: str, b: int) -> None:
        """Capture ``name`` at size ``b`` (``train.dispatch.capture``: warmed
        up on a side stream first), noting the kernels it launches."""
        captured = capture(self._programs[b].fns[name], self.device)
        if captured.kernels is None:
            raise RuntimeError(
                f"{name} at batch {b}: the launch log names only "
                f"{_build.LOGGED} launches")
        self.captured[name, b] = (captured.wrappers, captured.kernels)
        self._graphs[name, b] = captured.graph
        self._outputs[name, b] = captured.outputs

    def _run(self, name: str, b: int) -> Tuple[torch.Tensor, ...]:
        if self.device.type != "cuda":
            return self._programs[b].fns[name]()
        self._graphs[name, b].replay()
        wrappers, kernels = self.captured[name, b]
        self.launches.update(wrappers)
        self.kernel_launches.update(kernels)
        return self._outputs[name, b]

    def _size(self, b: int) -> _SizePrograms:
        if b not in self._programs:
            raise ValueError(f"batch {b} not in exported ladder {self.sizes}")
        return self._programs[b]

    @staticmethod
    def _fill(buf: torch.Tensor, value, what: str) -> None:
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(buf.shape):
            raise ValueError(
                f"{what} of shape {tuple(value.shape)}, the program takes "
                f"{tuple(buf.shape)}")
        buf.copy_(value)

    # ---------------------------------------------------------------- API

    @torch.inference_mode()
    def encode(self, seeds) -> np.ndarray:
        """(b, S, H, W, C) pixels -> (b, S, th, tw) int32 tokens."""
        seeds = np.asarray(seeds, dtype=np.float32)
        p = self._size(seeds.shape[0])
        with self._lock:
            self._fill(p.seeds, seeds, "seeds")
            (tokens,) = self._run("encode", seeds.shape[0])
            return tokens.cpu().numpy()

    @torch.inference_mode()
    def rollout(
        self,
        tokens,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Noise] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(b, S, th, tw) tokens -> ((b, T, H, W, C) pixels, the rolled
        (b, S, th, tw) context). The draws come from ``noise`` when given
        (``(frame, iteration) -> (gumbel, uniform)``, as ``rollout_frames``
        takes it), else from ``generator`` (a fresh one seeded 0 on the
        programs' device when neither is given). Spans: ``serve.frame``, a
        generated frame's draws and replays; ``serve.finish``, the finish
        replay and the read back."""
        tokens = torch.from_numpy(np.array(tokens)).long()
        b = tokens.shape[0]
        p = self._size(b)
        meta = self.meta
        k, frames = meta["num_embeddings"], meta["num_frames"]
        iterations = meta["num_iterations"]
        with self._lock:
            self._fill(p.tokens, tokens, "tokens")
            if noise is None:
                if generator is None:
                    generator = torch.Generator(device=self.device).manual_seed(0)
                noise = generator_noise(generator, tuple(p.uniform.shape), k)
            p.context.copy_(p.tokens)
            for t in range(frames):
                with tracing.span("serve.frame"):
                    p.z.copy_(p.context)
                    p.z[:, -1] = k
                    p.logits.zero_()
                    for i in range(iterations):
                        gumbel, uniform = noise(t, i)
                        p.gumbel.copy_(gumbel.reshape(p.gumbel.shape))
                        p.uniform.copy_(uniform.reshape(p.uniform.shape))
                        p.alpha.fill_(unmask_alpha(i, iterations))
                        topk = "step_topk" in p.fns and i >= TOPK_FROM_ITERATION
                        self._run("step_topk" if topk else "step", b)
                    p.gen[:, t] = p.z[:, -1]
                    p.context.copy_(shift_context(p.context, p.z[:, -1]))
            with tracing.span("serve.finish"):
                pixels, ctx = self._run("finish", b)
                return pixels.float().cpu().numpy(), ctx.cpu().numpy()
