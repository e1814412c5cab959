"""Interactive background-removal demo on the port (counterpart of
`demo/app.py`).

Model picker, visualization method (transparent / white / green / mask),
threshold slider, ambiguity warning from pairwise mask IoU, all-masks grid.

Two frontends:
- Gradio Blocks when `gradio` is installed (imported only then);
- a dependency-free stdlib HTTP server otherwise (upload form -> results),
  which doubles as a minimal serving endpoint (`POST /predict` returns the
  RGBA PNG, the IoU scores and the ambiguity flag in `X-S3OD-Info`).

The model is a local `.pt` / `.npz` checkpoint or a serving bundle
directory (`s3od_torch.aot`), served on the card unless `--device cpu`.
The port loads local files only, so the JAX demo's hub ids are not
offered.

Usage:
    python -m s3od_torch.demo_app --model PATH [--port 7860] [--http]
        [--device cpu] [--image-size 1024]
"""

from __future__ import annotations

import argparse
import base64
import io
import json
from pathlib import Path

import numpy as np
from PIL import Image

from s3od_torch.predictor import BackgroundRemoval
from s3od_torch.visualizer import visualize_removal

VISUALIZATION_METHODS = {
    "Transparent Background": "transparent",
    "White Background": "white",
    "Green Background": "green",
    "Mask Only": "mask",
}

_model_cache = {}
# Set by `main`: where and at what canvas the demo's models run.
DEVICE, IMAGE_SIZE = "cuda", 1024


def get_detector(model_id: str) -> BackgroundRemoval:
    """The predictor of a checkpoint or serving-bundle path, loaded once."""
    if model_id not in _model_cache:
        print(f"Loading model: {model_id}")
        if (Path(model_id) / "meta.json").exists():
            _model_cache[model_id] = BackgroundRemoval.from_serving_bundle(
                model_id, device=DEVICE)
        else:
            _model_cache[model_id] = BackgroundRemoval(
                model_id=model_id, image_size=IMAGE_SIZE, device=DEVICE)
    return _model_cache[model_id]


def compute_mask_iou(m1: np.ndarray, m2: np.ndarray) -> float:
    inter = np.logical_and(m1 > 0.5, m2 > 0.5).sum()
    union = np.logical_or(m1 > 0.5, m2 > 0.5).sum()
    return float(inter / (union + 1e-6))


def is_ambiguous(all_masks, threshold: float = 0.8) -> bool:
    """Prediction is ambiguous when any two candidate masks disagree."""
    for i in range(len(all_masks)):
        for j in range(i + 1, len(all_masks)):
            if compute_mask_iou(all_masks[i], all_masks[j]) < threshold:
                return True
    return False


def create_masks_grid(all_masks, image_shape) -> Image.Image:
    h, w = image_shape[:2]
    grid = Image.new("L", (w * len(all_masks), h), color=0)
    for idx, mask in enumerate(all_masks):
        grid.paste(Image.fromarray((mask * 255).astype(np.uint8), "L"), (idx * w, 0))
    return grid


def process_image(image: np.ndarray, model_id: str, method: str, threshold: float):
    detector = get_detector(model_id)
    result = detector.remove_background(image, threshold=threshold)

    if method == "white":
        main = visualize_removal(image, result, background_color=(255, 255, 255))
    elif method == "green":
        main = visualize_removal(image, result, background_color=(0, 255, 0))
    elif method == "mask":
        main = Image.fromarray((result.predicted_mask * 255).astype(np.uint8), "L")
    else:
        main = result.rgba_image

    grid = create_masks_grid(result.all_masks, image.shape)
    info = {
        "ious": [float(x) for x in result.all_ious],
        "best": int(result.all_ious.argmax()),
        "ambiguous": is_ambiguous(result.all_masks),
    }
    return main, grid, info


# ----------------------------------------------------------------------------
# Gradio frontend
# ----------------------------------------------------------------------------


def launch_gradio(default_model: str, port: int):
    import gradio as gr

    def run(image, model_id, method_key, threshold):
        if image is None:
            return None, None, ""
        method = VISUALIZATION_METHODS.get(method_key, "transparent")
        main, grid, info = process_image(np.array(image), model_id, method, threshold)
        note = (
            "Prediction is ambiguous — check the candidate masks."
            if info["ambiguous"]
            else f"IoU scores: {['%.3f' % s for s in info['ious']]}"
        )
        return main, grid, note

    with gr.Blocks(title="S3OD Background Removal") as demo:
        gr.Markdown("# S3OD — Salient Object Background Removal")
        with gr.Row():
            with gr.Column():
                inp = gr.Image(type="pil", label="Input")
                model_dd = gr.Textbox(value=default_model,
                                      label="Model (checkpoint or bundle path)")
                method_dd = gr.Dropdown(
                    list(VISUALIZATION_METHODS),
                    value=list(VISUALIZATION_METHODS)[0],
                    label="Visualization",
                )
                thr = gr.Slider(0.0, 1.0, 0.5, label="Threshold")
                btn = gr.Button("Remove Background")
            with gr.Column():
                out = gr.Image(label="Result")
                grid = gr.Image(label="All candidate masks")
                note = gr.Textbox(label="Info")
        btn.click(run, [inp, model_dd, method_dd, thr], [out, grid, note])
    demo.launch(server_port=port)


# ----------------------------------------------------------------------------
# Stdlib HTTP fallback / serving endpoint
# ----------------------------------------------------------------------------

_FORM = """<!doctype html><title>S3OD demo</title>
<h1>S3OD — Background Removal</h1>
<form method=post action=/predict_page enctype=multipart/form-data>
<input type=file name=image accept=image/*>
<select name=method>{options}</select>
<input type=submit value="Remove background">
</form>"""


def make_http_server(default_model: str, port: int):
    """Build (not run) the stdlib HTTP server — separated so tests can
    serve on an ephemeral port in a thread."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    get_detector(default_model)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            print("[demo]", fmt % args)

        def do_GET(self):
            opts = "".join(
                f"<option value={v}>{k}</option>"
                for k, v in VISUALIZATION_METHODS.items()
            )
            body = _FORM.format(options=opts).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(body)

        def _read_image(self):
            # No `cgi` (removed in Python 3.13): multipart via the email
            # parser; a non-multipart POST body is treated as raw image
            # bytes (handy for `curl --data-binary @img.png /predict`).
            ctype = self.headers.get("Content-Type", "")
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            method = "transparent"
            if ctype.startswith("multipart/form-data"):
                import email
                import email.policy

                msg = email.message_from_bytes(
                    b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body,
                    policy=email.policy.HTTP,
                )
                data = None
                for part in msg.iter_parts():
                    name = part.get_param(
                        "name", header="Content-Disposition"
                    )
                    if name == "image":
                        data = part.get_payload(decode=True)
                    elif name == "method":
                        method = (
                            part.get_payload(decode=True).decode().strip()
                        )
                if data is None:
                    raise ValueError("multipart body has no 'image' field")
            else:
                data = body
            img = Image.open(io.BytesIO(data)).convert("RGB")
            return np.array(img), method

        def do_POST(self):
            if self.path not in ("/predict", "/predict_page"):
                self.send_error(404)
                return
            try:
                image, method = self._read_image()
            except Exception as e:  # noqa: BLE001
                self.send_error(400, f"bad request: {e}")
                return
            main, grid, info = process_image(image, default_model, method, 0.5)
            buf = io.BytesIO()
            main.save(buf, format="PNG")
            if self.path == "/predict":
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("X-S3OD-Info", json.dumps(info))
                self.end_headers()
                self.wfile.write(buf.getvalue())
                return
            gbuf = io.BytesIO()
            grid.save(gbuf, format="PNG")
            html = (
                "<h1>Result</h1>"
                f"<p>{json.dumps(info)}</p>"
                f'<img src="data:image/png;base64,{base64.b64encode(buf.getvalue()).decode()}">'
                "<h2>All masks</h2>"
                f'<img src="data:image/png;base64,{base64.b64encode(gbuf.getvalue()).decode()}">'
            ).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(html)

    return HTTPServer(("0.0.0.0", port), Handler)


def launch_http(default_model: str, port: int):
    server = make_http_server(default_model, port)
    print(f"Serving on http://0.0.0.0:{port} (POST /predict for raw RGBA PNG)")
    server.serve_forever()


def main(argv=None):
    global DEVICE, IMAGE_SIZE
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", required=True,
                    help="a local .pt / .npz checkpoint or a serving bundle")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--http", action="store_true",
                    help="force the stdlib HTTP frontend")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--image-size", type=int, default=1024)
    args = ap.parse_args(argv)
    DEVICE, IMAGE_SIZE = args.device, args.image_size
    if not args.http:
        try:
            import gradio  # noqa: F401

            launch_gradio(args.model, args.port)
            return
        except ImportError:
            print("gradio not installed; falling back to stdlib HTTP demo")
    launch_http(args.model, args.port)


if __name__ == "__main__":
    main()
