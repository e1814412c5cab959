"""Background-removal inference API on PyTorch (counterpart of
`s3od_tpu/predictor.py`).

Same contract as the JAX predictor: letterbox to a square canvas on the
host, upload uint8, normalize -> encoder -> DPT head -> sigmoid on the
device, then unpad, resize back with antialiasing, pick the mask with the
best IoU score and compose RGBA on the host. bf16 on CUDA by default
(through the hand-written kernels), float32 exact mode otherwise.

Entry points: `remove_background` (one image), `remove_background_batch`
(device steps of up to 16 images a replica; with `data_parallel` the
model is replicated on every visible card, or on the devices given, and
each step split across the replicas), `remove_background_stream` (pipelined:
host pre- and postprocess overlap the device), each with a readback
`payload` of "full" (all soft masks), "best" (the best mask, chosen and
quantized to uint8 on the device) or "best_small" ("best" pooled 2x2).
`s3od_torch.serving.InferenceServer` serves this predictor.
`BackgroundRemoval.from_serving_bundle` loads a serving bundle
(`s3od_torch.aot`): its exported graphs serve the batches it holds.

`RemovalResult` and the host resize helpers are the port's own copies of
the JAX package's.
"""

from __future__ import annotations

import contextlib
import copy
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import (Any, Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
from PIL import Image

from s3od_torch.configs import SegmentationConfig
from s3od_torch.convert import load_checkpoint, state_dict_from_jax
from s3od_torch.models.segmentation import S3ODSegmentation
from s3od_torch.ops.precision import default_dtype, set_exact_float32
from s3od_torch.ops.resize import resize_bilinear_numpy
from s3od_torch.utils import as_rgb_uint8, get_pad_info, place_on_canvas, remove_padding

# ImageNet statistics (reference `src/s3od/predictor.py:42-43`).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
PAYLOADS = ("full", "best", "best_small")
UPLOADS = ("bucket", "canvas")


@dataclass
class RemovalResult:
    predicted_mask: np.ndarray
    all_masks: np.ndarray
    all_ious: np.ndarray
    rgba_image: Image.Image


def _resize_image(image: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """uint8 HWC resize; cv2 INTER_LINEAR when available, else the matched
    numpy bilinear (the JAX predictor's rule)."""
    try:
        import cv2

        return cv2.resize(image, (out_hw[1], out_hw[0]))
    except ImportError:
        out = resize_bilinear_numpy(image.astype(np.float32), out_hw,
                                    h_axis=0, w_axis=1)
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _masks_to_original(masks_nhw: np.ndarray,
                       out_hw: Tuple[int, int]) -> np.ndarray:
    """(n, h, w) soft masks -> (n, H, W) at the original size, clipped.
    Antialiasing changes only downscales, so upscales take cv2's bilinear
    when available; downscales keep the torch-matched triangle filter."""
    ih, iw = masks_nhw.shape[1:]
    oh, ow = out_hw
    if oh >= ih and ow >= iw:
        try:
            import cv2

            out = np.stack([cv2.resize(m, (ow, oh), interpolation=cv2.INTER_LINEAR)
                            for m in masks_nhw])
            return np.clip(out, 0.0, 1.0)
        except ImportError:
            pass
    return np.clip(resize_bilinear_numpy(masks_nhw, out_hw, antialias=True,
                                         h_axis=1, w_axis=2), 0.0, 1.0)


def _postprocess(image: np.ndarray, pad_info, masks_nc: np.ndarray,
                 ious: np.ndarray) -> RemovalResult:
    """Unpad -> resize to the original size -> argmax-IoU selection ->
    RGBA. `masks_nc`: (n, S, S) fp32 soft masks on the padded canvas."""
    all_masks = _masks_to_original(remove_padding(masks_nc, pad_info),
                                   pad_info["original_size"])
    best = int(ious.argmax())
    alpha = (all_masks[best] * 255).astype(np.uint8)
    return RemovalResult(
        predicted_mask=all_masks[best],
        all_masks=all_masks,
        all_ious=ious,
        rgba_image=Image.fromarray(np.dstack([image, alpha]), mode="RGBA"),
    )


def _postprocess_best(image: np.ndarray, pad_info, mask_u8: np.ndarray,
                      ious: np.ndarray) -> RemovalResult:
    """Epilogue of the reduced payloads: the device already chose the
    argmax-IoU mask and quantized it to uint8, so only unpad -> resize ->
    RGBA remain. `all_masks` holds just that mask, (1, H, W); `all_ious`
    is the full vector. A half-resolution mask ("best_small") is first
    restored bilinearly to the canvas, so the unpad offsets stay exact."""
    mask = mask_u8.astype(np.float32) * (1.0 / 255.0)
    canvas = max(pad_info["resized_size"])  # the longest side is the canvas
    if mask.shape[0] != canvas:
        try:
            import cv2

            mask = cv2.resize(mask, (canvas, canvas),
                              interpolation=cv2.INTER_LINEAR)
        except ImportError:
            mask = resize_bilinear_numpy(mask[None], (canvas, canvas),
                                         h_axis=1, w_axis=2)[0]
        mask = np.clip(mask, 0.0, 1.0)
    m = _masks_to_original(remove_padding(mask[None], pad_info),
                           pad_info["original_size"])
    alpha = (m[0] * 255).astype(np.uint8)
    return RemovalResult(
        predicted_mask=m[0],
        all_masks=m,
        all_ious=ious,
        rgba_image=Image.fromarray(np.dstack([image, alpha]), mode="RGBA"),
    )


def serving_forward(model_fn, x_u8: torch.Tensor, mean: torch.Tensor,
                    inv_std: torch.Tensor, dtype: torch.dtype,
                    payload: str = "full"):
    """The serving forward: (B, S, S, 3) uint8 canvases -> (masks, ious),
    ious (B, n) fp32 sigmoid scores. `model_fn(x)` runs the model
    (`serving_fast_output`) on the images normalized in `dtype`. masks:
    "full" (B, n, S, S) sigmoid in the compute dtype; "best" (B, S, S)
    uint8, the argmax-IoU mask's fp32 sigmoid x 255 rounded half to even;
    "best_small" the same after a 2x2 mean, (B, S/2, S/2). The eager
    predictor and every exported graph (`s3od_torch.aot`) run this."""
    x = ((x_u8.float() - mean) * inv_std).to(dtype)
    out = model_fn(x)
    ious = torch.sigmoid(out["pred_iou"])
    if payload == "full":
        return torch.sigmoid(out["pred_masks"]), ious
    b = x.shape[0]
    best = ious.argmax(-1)
    logits = out["pred_masks"][torch.arange(b, device=best.device), best]
    mask = torch.sigmoid(logits.float())
    if payload == "best_small":
        s = mask.shape[-1]
        mask = mask.reshape(b, s // 2, 2, s // 2, 2).mean((2, 4))
    return torch.round(mask * 255.0).to(torch.uint8), ious


def _check(value: str, allowed, what: str) -> None:
    if value not in allowed:
        raise ValueError(f"{what} must be one of {allowed}, got {value!r}")


class BackgroundRemoval:
    DEFAULT_CHECKPOINT_NAME = "s3od.pt"
    BATCH_CHUNK = 16

    def __init__(
        self,
        model_id: Optional[str] = None,
        image_size: int = 1024,
        device: str = "cuda",
        dtype: Optional[str] = None,
        fold_bn: bool = True,
        data_parallel: Union[bool, Sequence[Union[str, torch.device]]] = False,
        _model: Optional[S3ODSegmentation] = None,
    ):
        """`data_parallel`: one replica of the model a device, and each
        device step split across them (`forward_canvases`; 16 images a
        replica by default in `remove_background_batch`). True: every
        visible CUDA card, `device` first (on one card, or on the CPU, one
        replica: the path of `data_parallel=False`). A list of devices: one
        replica on each, the first being `device`; a device may repeat."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BackgroundRemoval(device='cuda') needs a CUDA device; pass "
                "device='cpu' to run the plain PyTorch path")
        if dtype is not None and dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        self.compute_dtype = (_DTYPES[dtype] if dtype is not None
                              else default_dtype(self.device))
        if self.compute_dtype == torch.float32:
            set_exact_float32()
        self.image_size = image_size
        if _model is None:
            if model_id is None:
                raise ValueError("model_id (a .pt / .npz path) is required")
            sd, cfg = load_checkpoint(self._resolve(model_id))
            _model = S3ODSegmentation(cfg)
            _model.load_state_dict(sd, strict=True)
        self.model = _model.prepare_serving_(self.compute_dtype, fold_bn)
        self.model.to(self.device)
        self.cfg = self.model.cfg
        self._mean = torch.tensor(IMAGENET_MEAN * 255.0, device=self.device)
        self._inv_std = torch.tensor(1.0 / (IMAGENET_STD * 255.0),
                                     device=self.device)
        # (model, mean, inv_std) a replica; the first is `model` on `device`.
        self._replicas = [(self.model, self._mean, self._inv_std)]
        for dev in self._replica_devices(data_parallel)[1:]:
            self._replicas.append((copy.deepcopy(self.model).to(dev),
                                   self._mean.to(dev), self._inv_std.to(dev)))
        # The serving bundle's graphs by (batch, payload), and their canvas
        # (`from_serving_bundle`); empty otherwise.
        self._aot: Dict[Tuple[int, str], Any] = {}
        self._aot_canvas: Optional[int] = None

    def _replica_devices(self, data_parallel) -> List[torch.device]:
        first = self._mean.device
        if data_parallel is True:
            if first.type != "cuda":
                return [first]
            return [first] + [torch.device("cuda", i)
                              for i in range(torch.cuda.device_count())
                              if i != first.index]
        if not data_parallel:
            return [first]
        devices = [torch.device(d) for d in data_parallel]
        if devices[0].type == "cuda" and devices[0].index is None:
            devices[0] = torch.device("cuda", torch.cuda.current_device())
        if devices[0] != first:
            raise ValueError(f"data_parallel's first device {devices[0]} is "
                             f"not the predictor's device {first}")
        return devices

    @classmethod
    def from_pretrained(cls, model_id: str, **kwargs) -> "BackgroundRemoval":
        return cls(model_id=model_id, **kwargs)

    @classmethod
    def from_params(cls, params: dict, state: Optional[dict],
                    cfg: SegmentationConfig, **kwargs) -> "BackgroundRemoval":
        """From a JAX-layout param pytree (numpy leaves)."""
        model = S3ODSegmentation(cfg)
        model.load_state_dict(state_dict_from_jax(params, state), strict=True)
        return cls(_model=model, **kwargs)

    @classmethod
    def from_model(cls, model: S3ODSegmentation, **kwargs) -> "BackgroundRemoval":
        """From a constructed model (e.g. seeded random weights); the
        model is prepared in place."""
        return cls(_model=model, **kwargs)

    @classmethod
    def from_serving_bundle(cls, path, **kwargs) -> "BackgroundRemoval":
        """From a serving bundle (`s3od_torch.aot`): the bundle's prepared
        weights, and its exported graphs for the batches and payloads it
        holds at its canvas. `device` defaults to "cuda" as for the
        constructor and must be the bundle's; a `dtype` other than the
        bundle's raises; BN folding is skipped (the bundle's tree is
        folded already)."""
        from s3od_torch.aot import load_serving_bundle

        if kwargs.get("data_parallel"):
            raise ValueError("a serving bundle's graphs are bound to one "
                             "device: load one predictor a device")
        device = kwargs.get("device", "cuda")
        bundle = load_serving_bundle(path, device=device)
        if kwargs.get("dtype") not in (None, bundle.meta["dtype"]):
            raise ValueError(
                f"dtype={kwargs['dtype']!r} conflicts with the bundle's "
                f"dtype={bundle.meta['dtype']!r}; re-export the bundle "
                "with the desired dtype instead")
        kwargs.setdefault("dtype", bundle.meta["dtype"])
        kwargs.setdefault("image_size", bundle.meta["image_size"])
        kwargs["fold_bn"] = False
        pred = cls(_model=bundle.model, **kwargs)
        pred._aot = dict(bundle.graphs)
        pred._aot_canvas = bundle.meta["image_size"]
        return pred

    @classmethod
    def _resolve(cls, model_id: str) -> Path:
        path = Path(model_id)
        if path.is_dir():
            for name in (cls.DEFAULT_CHECKPOINT_NAME, "s3od.npz"):
                if (path / name).exists():
                    return path / name
            raise ValueError(f"No checkpoint found under {model_id}")
        if not path.exists():
            raise ValueError(
                f"{model_id} is not a local checkpoint; the port loads local "
                ".pt / .npz files only")
        return path

    def _preprocess(self, image: np.ndarray) -> Tuple[np.ndarray, Dict[str, Any]]:
        pad_info = get_pad_info(image, self.image_size)
        resized = _resize_image(image, pad_info["resized_size"])
        return place_on_canvas(resized, self.image_size, pad_info), pad_info

    # Bucketed upload: send only the letterboxed image, its height and width
    # rounded up to a granule, and complete the zero canvas on the device
    # (`s3od_tpu/predictor.py:383-427`): about 28% fewer host-to-device
    # bytes on real aspect ratios.

    def _bucket_preprocess(
        self, image: np.ndarray
    ) -> Tuple[np.ndarray, Tuple[int, int], Dict[str, Any]]:
        """Resize and pack into the smallest granule-aligned buffer, at an
        inner offset chosen so that placing the WHOLE buffer at the
        (clamped) outer offset reproduces `place_on_canvas` bit for bit."""
        s = self.image_size
        pad_info = get_pad_info(image, s)
        resized = _resize_image(image, pad_info["resized_size"])
        g = max(32, s // 8)
        rh, rw = resized.shape[:2]
        bh = min(s, -(-rh // g) * g)
        bw = min(s, -(-rw // g) * g)
        top, left = pad_info["height_pad"], pad_info["width_pad"]
        outer_t, outer_l = min(top, s - bh), min(left, s - bw)
        buf = np.zeros((bh, bw, 3), np.uint8)
        it, il = top - outer_t, left - outer_l
        buf[it: it + rh, il: il + rw] = resized
        return buf, (outer_t, outer_l), pad_info

    def _place(self, buf: np.ndarray, tl: Tuple[int, int]) -> torch.Tensor:
        """Upload a bucket buffer and complete its zero canvas on the
        device: (S, S, 3) uint8."""
        s = self.image_size
        canvas = torch.zeros((s, s, 3), dtype=torch.uint8, device=self.device)
        t, l = tl
        canvas[t: t + buf.shape[0], l: l + buf.shape[1]] = (
            torch.from_numpy(buf).to(self.device))
        return canvas

    def _upload(self, canvases, replica: int = 0) -> torch.Tensor:
        """(B, S, S, 3) uint8 host canvases (an array or a list) -> the
        replica's device."""
        return torch.from_numpy(np.stack(canvases)).to(
            self._replicas[replica][1].device)

    @torch.inference_mode()
    def _forward_device(self, x_u8: torch.Tensor, payload: str = "full",
                        replica: int = 0):
        """(B, S, S, 3) uint8 canvases on the replica's device -> (masks,
        ious) there, as `serving_forward` gives them. A predictor loaded
        from a serving bundle runs the bundle's exported graph for a
        (batch, payload) it holds at the bundle's canvas, and the eager
        forward otherwise (as the JAX predictor falls back to jit)."""
        graph = (self._aot.get((int(x_u8.shape[0]), payload))
                 if x_u8.shape[1] == self._aot_canvas else None)
        if graph is not None:
            return graph(x_u8)
        model, mean, inv_std = self._replicas[replica]
        with (torch.cuda.device(mean.device) if mean.device.type == "cuda"
              else contextlib.nullcontext()):
            return serving_forward(
                lambda x: model(x, serving_fast_output=True), x_u8, mean,
                inv_std, self.compute_dtype, payload)

    @staticmethod
    def _readback(masks: torch.Tensor, ious: torch.Tensor):
        """One device-to-host copy of each output: (masks as fp32 or uint8
        numpy, ious fp32 numpy)."""
        if masks.dtype != torch.uint8:
            masks = masks.float()
        return masks.cpu().numpy(), ious.float().cpu().numpy()

    @staticmethod
    def _finish(image, pad_info, mask, ious, payload) -> RemovalResult:
        if payload == "full":
            return _postprocess(image, pad_info, mask, ious)
        return _postprocess_best(image, pad_info, mask, ious)

    def forward_canvases(self, canvases_u8: np.ndarray, payload: str = "full"):
        """(B, S, S, 3) uint8 canvases -> (masks, sigmoid IoU scores (B, n)
        fp32) as numpy; masks as `_forward_device` gives them for
        `payload`, the "full" ones as (B, n, S, S) fp32. The batch is split
        in order across the replicas (`np.array_split`: no padding, the
        first parts one larger where it does not split evenly); every
        part's forward is queued before any is read back."""
        _check(payload, PAYLOADS, "payload")
        parts = [p for p in np.array_split(canvases_u8, len(self._replicas))
                 if len(p)]
        outs = [self._forward_device(self._upload(p, i), payload, i)
                for i, p in enumerate(parts)]
        read = [self._readback(m, i) for m, i in outs]
        if len(read) == 1:
            return read[0]
        return (np.concatenate([m for m, _ in read]),
                np.concatenate([i for _, i in read]))

    def remove_background(self, image: Union[np.ndarray, Image.Image],
                          threshold: float = 0.5,
                          payload: str = "full") -> RemovalResult:
        image = as_rgb_uint8(image)
        canvas, pad_info = self._preprocess(image)
        masks, ious = self.forward_canvases(canvas[None], payload)
        return self._finish(image, pad_info, masks[0], ious[0], payload)

    def remove_background_batch(
        self, images: List[Union[np.ndarray, Image.Image]],
        threshold: float = 0.5, chunk: Optional[int] = None,
        payload: str = "full",
    ) -> List[RemovalResult]:
        """Batched inference: device steps over chunks of `chunk` images
        (default 16 a replica), host postprocess per image. The JAX
        predictor pads a short final chunk up to a power of two (and to a
        multiple of its devices) so that jit compiles fewer shapes;
        PyTorch runs eagerly, so a chunk runs at its own size, split
        across the replicas by `forward_canvases`."""
        chunk = chunk or self.BATCH_CHUNK * len(self._replicas)
        arrays = [as_rgb_uint8(im) for im in images]
        results: List[RemovalResult] = []
        for i in range(0, len(arrays), chunk):
            group = arrays[i: i + chunk]
            pre = [self._preprocess(a) for a in group]
            masks, ious = self.forward_canvases(
                np.stack([c for c, _ in pre]), payload)
            results.extend(
                self._finish(a, pi, masks[j], ious[j], payload)
                for j, (a, (_, pi)) in enumerate(zip(group, pre)))
        return results

    def remove_background_stream(
        self,
        images: Iterable[Union[np.ndarray, Image.Image]],
        threshold: float = 0.5,
        depth: int = 3,
        post_workers: int = 2,
        pre_workers: int = 2,
        batch: int = 1,
        payload: str = "full",
        upload: Optional[str] = None,
    ) -> Iterator[RemovalResult]:
        """Pipelined inference: yields `RemovalResult`s in order while host
        preprocess, device compute and host postprocess overlap
        (`s3od_tpu/predictor.py:500-639`).

        `pre_workers` threads letterbox, upload and launch the forward of
        up to `depth` device steps ahead; `post_workers` threads read each
        step back and postprocess it. All steps queue on the device's
        default stream, in launch order; a readback waits on that stream,
        never on the whole device. (One CUDA stream per pre worker measured
        no faster on an H100.) In-flight work is bounded by depth +
        post_workers, so memory stays flat on long streams.

        `batch` > 1 groups the images into device steps of `batch`; the
        last group is padded with copies of its first image, whose outputs
        are dropped. `payload` is as for `remove_background`. `upload`:
        "bucket" (the default on CUDA) uploads the granule-rounded
        letterboxed image and completes the zero canvas on the device;
        "canvas" (the default on the CPU) uploads the whole canvas. The
        two give bit-identical results; "canvas" stays for parity with the
        JAX API and as the reference of the bucketed upload's test, and
        is the branch to drop once that parity is no longer needed."""
        _check(payload, PAYLOADS, "payload")
        if upload is None:
            upload = "bucket" if self.device.type == "cuda" else "canvas"
        _check(upload, UPLOADS, "upload")
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")

        def launch(group):
            # Runs on a pre worker. Inference mode is thread-local, so
            # `_forward_device` enters it here, in the worker.
            arrays, infos, canvases = [], [], []
            for image in group:
                image = as_rgb_uint8(image)
                if upload == "bucket":
                    buf, tl, pad_info = self._bucket_preprocess(image)
                    canvases.append(self._place(buf, tl))
                else:
                    canvas, pad_info = self._preprocess(image)
                    canvases.append(canvas)
                arrays.append(image)
                infos.append(pad_info)
            canvases += [canvases[0]] * (batch - len(group))
            x = (torch.stack(canvases) if upload == "bucket"
                 else self._upload(canvases))
            masks, ious = self._forward_device(x, payload)
            return arrays, infos, masks, ious

        def post(arrays, infos, masks, ious):
            masks_np, ious_np = self._readback(masks, ious)
            return [self._finish(a, pi, masks_np[j], ious_np[j], payload)
                    for j, (a, pi) in enumerate(zip(arrays, infos))]

        def grouped(seq):
            group = []
            for image in seq:
                group.append(image)
                if len(group) == batch:
                    yield group
                    group = []
            if group:
                yield group

        groups = grouped(iter(images))
        inflight: deque = deque()  # launch futures, in order
        done: deque = deque()      # postprocess futures, in order
        with ThreadPoolExecutor(post_workers) as post_pool, \
                ThreadPoolExecutor(pre_workers) as pre_pool:
            exhausted = False
            while True:
                while not exhausted and len(inflight) < depth:
                    try:
                        inflight.append(pre_pool.submit(launch, next(groups)))
                    except StopIteration:
                        exhausted = True
                if inflight:
                    # Bound the finished results held: wait on the oldest
                    # when uploads outrun compute and postprocess.
                    while len(done) >= depth + post_workers:
                        yield from done.popleft().result()
                    done.append(post_pool.submit(
                        post, *inflight.popleft().result()))
                elif not done:
                    break
                while done and (done[0].done() or not inflight):
                    yield from done.popleft().result()
                if exhausted and not inflight:
                    while done:
                        yield from done.popleft().result()
                    break
