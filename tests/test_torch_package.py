"""s3od_torch package boundaries: no jax, no triton and no module of the
JAX package (s3od_tpu) on import or on a CPU forward, none named in the
port's sources, CUDA required for device="cuda", and the kernel build
inputs."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "s3od_torch"

# Under pytest-xdist the workers share the host's cores. Each worker
# imports every test module while collecting, so this sets torch's
# intra-op threads for the whole session: a worker's share of the cores.
# At torch's default (all cores in every worker) OpenMP's waits cost up to
# 500x on the port tests' small ops (a 0.08 s case read 41 s under load).
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))


def test_import_and_cpu_forward_leave_jax_and_triton_out():
    code = (
        "import sys\n"
        "import s3od_torch\n"
        "from s3od_torch import BackgroundRemoval\n"
        "import numpy as np\n"
        "p = BackgroundRemoval('tests/fixture/tiny_s3od.npz', image_size=64,"
        " device='cpu')\n"
        "r = p.remove_background(np.zeros((48, 80, 3), np.uint8))\n"
        "assert r.all_masks.shape == (3, 48, 80)\n"
        "print('jax' in sys.modules, 'triton' in sys.modules,\n"
        "      any(m.split('.')[0] == 's3od_tpu' for m in sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "False"]


def test_new_modules_and_cpu_stream_leave_jax_and_triton_out():
    """The fused MLP, the evaluation modules and a CPU run of the stream
    API, SODPredictor and InferenceServer import neither jax, nor triton,
    nor any module of s3od_tpu."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import s3od_torch.ops.mlp_fused\n"
        "from s3od_torch.evaluation.compute_metrics import evaluate_datasets\n"
        "from s3od_torch.evaluation.predictor import SODPredictor\n"
        "from s3od_torch import BackgroundRemoval\n"
        "from s3od_torch.serving import InferenceServer\n"
        "p = BackgroundRemoval('tests/fixture/tiny_s3od.npz', image_size=64,"
        " device='cpu')\n"
        "ims = [np.zeros((48, 80, 3), np.uint8)] * 3\n"
        "r = list(p.remove_background_stream(ims, batch=2, payload='best'))\n"
        "assert len(r) == 3 and r[0].all_masks.shape == (1, 48, 80)\n"
        "s = SODPredictor('tests/fixture/tiny_s3od.npz', image_size=64,"
        " device='cpu').predict(ims[0])\n"
        "assert s.soft_mask.shape == (48, 80)\n"
        "srv = InferenceServer(p, max_batch=2).start()\n"
        "assert srv.submit(ims[0]).all_masks.shape == (3, 48, 80)\n"
        "srv.stop()\n"
        "print('jax' in sys.modules, 'triton' in sys.modules,\n"
        "      any(m.split('.')[0] == 's3od_tpu' for m in sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "False"]


def test_training_import_and_cpu_step_leave_jax_triton_and_s3od_tpu_out():
    """`import s3od_torch.training.train` and one tiny float32 training
    step on the CPU import neither jax, nor triton, nor any module of
    s3od_tpu."""
    code = (
        "import sys\n"
        "import torch\n"
        "import s3od_torch.training.train\n"
        "from s3od_torch.configs import tiny_test_config\n"
        "from s3od_torch.models.segmentation import S3ODSegmentation, init_weights_\n"
        "from s3od_torch.training.loss import LOSS_PRESETS, LossModule\n"
        "from s3od_torch.training.optim import Optimizer\n"
        "from s3od_torch.training.train_step import train_step\n"
        "m = init_weights_(S3ODSegmentation(tiny_test_config()),"
        " torch.Generator().manual_seed(0))\n"
        "b = {'images': torch.zeros(2, 64, 64, 3, dtype=torch.uint8),"
        " 'masks': torch.full((2, 64, 64), 255, dtype=torch.uint8)}\n"
        "out = train_step(m, Optimizer(m, 1e-4, steps_per_epoch=1),"
        " LossModule(LOSS_PRESETS['focal_iou']), b, 0, 0,"
        " generator=torch.Generator().manual_seed(1))\n"
        "assert torch.isfinite(out['loss'])\n"
        "print('jax' in sys.modules, 'triton' in sys.modules,\n"
        "      any(m.split('.')[0] == 's3od_tpu' for m in sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "False"]


def _ddp_step_in_a_worker():
    """One DDP step of the tiny model in a spawned gloo worker (the
    parallel package, the train step, global-batch BatchNorm); the
    top-level packages it loaded among jax, triton and s3od_tpu."""
    from s3od_torch.configs import tiny_test_config
    from s3od_torch.models.segmentation import S3ODSegmentation, init_weights_
    from s3od_torch.parallel import make_mesh, shard_module
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.optim import Optimizer
    from s3od_torch.training.train_step import train_step

    m = init_weights_(S3ODSegmentation(tiny_test_config()),
                      torch.Generator().manual_seed(0))
    ddp = shard_module(m, make_mesh(device_type="cpu"))
    b = {"images": torch.zeros(2, 32, 32, 3, dtype=torch.uint8),
         "masks": torch.full((2, 32, 32), 255, dtype=torch.uint8)}
    out = train_step(ddp, Optimizer(m, 1e-4, steps_per_epoch=1),
                     LossModule(LOSS_PRESETS["focal_iou"]), b, 0, 0,
                     generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(out["loss"])
    return sorted({n.split(".")[0] for n in sys.modules}
                  & {"jax", "triton", "s3od_tpu"}), type(ddp).__name__


def test_spawned_data_parallel_workers_leave_jax_triton_and_s3od_tpu_out():
    """Workers spawned by `parallel.spawn_local` (as `backend.devices=N`
    starts them) import this module to find their function: a DDP step
    there imports neither jax, nor triton, nor any module of s3od_tpu."""
    from s3od_torch.parallel.distributed import spawn_local

    res = spawn_local(2, _ddp_step_in_a_worker, device_type="cpu", threads=1,
                      timeout=300)
    assert res == {r: ([], "DistributedDataParallel") for r in (0, 1)}


def test_factory_cpu_generation_leaves_jax_triton_transformers_out():
    """The factory modules (`s3od_torch.datagen.*`, the MMDiT, text
    encoders, VAE and teacher) and a tiny CPU generation through
    `ImageMaskGenerationPipeline` import neither jax, nor triton, nor
    transformers, nor any module of s3od_tpu."""
    code = (
        "import sys, tempfile, torch\n"
        "import s3od_torch.datagen.generate_train_images as g\n"
        "import s3od_torch.datagen.text_encoding, s3od_torch.datagen.resizer\n"
        "from s3od_torch.configs import tiny_test_config\n"
        "from s3od_torch.datagen.diffusion import ConceptAttentionPipeline\n"
        "from s3od_torch.datagen.mask_generator import MaskGenerator\n"
        "from s3od_torch.datagen.text_encoding import TorchTextEncoders\n"
        "from s3od_torch.models import mmdit, text_encoders as te, vae\n"
        "from s3od_torch.models.flux_teacher import FluxTeacherConfig,"
        " init_flux_teacher\n"
        "gen = torch.Generator().manual_seed(0)\n"
        "cfg = mmdit.MMDiTConfig(hidden_size=96, num_heads=4,"
        " num_dual_blocks=1, num_single_blocks=4, text_dim=64, pooled_dim=32,"
        " in_channels=16, axes_dims=(8, 8, 8), feature_taps=(0, 1, 2, 3))\n"
        "vcfg = vae.VAEConfig(latent_channels=4, base_channels=8,"
        " channel_mults=(1, 1, 1, 1), layers_per_block=1, groups=4)\n"
        "enc = TorchTextEncoders.random_init(0, te.T5Config(vocab_size=300,"
        " d_model=64, d_kv=16, d_ff=96, num_layers=1, num_heads=4),"
        " te.CLIPTextConfig(vocab_size=400, hidden_size=32,"
        " intermediate_size=64, num_layers=1, num_heads=2),"
        " max_t5_tokens=16, device='cpu')\n"
        "pipe = ConceptAttentionPipeline(mmdit.init_mmdit(cfg, gen),"
        " text_encoders=enc, vae=vae.VAE(*vae.init_vae(vcfg, gen), vcfg,"
        " device='cpu'), num_inference_steps=2, device='cpu')\n"
        "mg = MaskGenerator(model=init_flux_teacher(FluxTeacherConfig("
        "base=tiny_test_config(), flux_dim=24), gen), device='cpu')\n"
        "g.GENERATION_RESOLUTIONS = [(64, 96)]\n"
        "d = tempfile.mkdtemp()\n"
        "c = g.GenerationConfig(output_dir=d + '/o', prompts_dir=d + '/p')\n"
        "assert g.ImageMaskGenerationPipeline(c, pipe, mg)"
        ".process_class('tabby cat', 1) == 1\n"
        "print([any(m.split('.')[0] == n for m in sys.modules)\n"
        "       for n in ('jax', 'triton', 'transformers', 's3od_tpu')])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[False,", "False,", "False,", "False]"]


def test_last_modules_leave_jax_triton_transformers_and_s3od_tpu_out():
    """The modules ported last (int8 residency, the FLUX and text-encoder
    converters, the filter chain and its CLIs, the metadata CLI, teacher
    training's dataset and entry point), an int8 tiny MMDiT forward and a
    heuristic filter verdict, run on the CPU, import neither jax, nor
    triton, nor transformers, nor any module of s3od_tpu."""
    code = (
        "import sys, tempfile, numpy as np, torch\n"
        "from pathlib import Path\n"
        "from PIL import Image\n"
        "import s3od_torch.datagen.convert_flux\n"
        "import s3od_torch.datagen.convert_text_encoders\n"
        "import s3od_torch.datagen.run_filtering\n"
        "import s3od_torch.datagen.generate_metadata\n"
        "import s3od_torch.training.train\n"
        "from s3od_torch.training.data import FluxFeatureDataset\n"
        "from s3od_torch.datagen.filtering import Sample\n"
        "from s3od_torch.datagen.filters import GemmaMaskArtifactFilter\n"
        "from s3od_torch.ops import quant\n"
        "from s3od_torch.models import mmdit\n"
        "quant.MIN_QUANT_DIM = 32\n"
        "m = mmdit.init_mmdit(mmdit.tiny_mmdit_config(),"
        " torch.Generator().manual_seed(0), int8_weights=True)\n"
        "ids = torch.zeros(4, 3)\n"
        "out = m(latents=torch.zeros(1, 4, 16), txt=torch.zeros(1, 4, 64),"
        " pooled=torch.zeros(1, 32), timestep=torch.ones(1),"
        " img_ids=ids, txt_ids=ids, compute_dtype=torch.float32)\n"
        "assert torch.isfinite(out['output']).all()\n"
        "d = Path(tempfile.mkdtemp())\n"
        "Image.fromarray(np.full((8, 8), 255, np.uint8)).save(d / 'm.png')\n"
        "r = GemmaMaskArtifactFilter(model_id='/nonexistent', device='cpu')"
        ".filter(Sample(d / 'i.jpg', d / 'm.png', 'c', '0'))\n"
        "assert r.passed and r.metadata['heuristic']\n"
        "print([any(m.split('.')[0] == n for m in sys.modules)\n"
        "       for n in ('jax', 'triton', 'transformers', 's3od_tpu')])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[False,", "False,", "False,", "False]"]


def test_factory_entry_points_default_to_the_card():
    """Without a card, every factory entry point refuses its default
    device rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from s3od_torch.datagen.diffusion import ConceptAttentionPipeline
    from s3od_torch.datagen.mask_generator import MaskGenerator
    from s3od_torch.datagen.text_encoding import TorchTextEncoders
    from s3od_torch.models.mmdit import MMDiT, tiny_mmdit_config
    from s3od_torch.models.vae import VAE, VAEDecoder, VAEEncoder, tiny_vae_config

    vcfg = tiny_vae_config()
    calls = [
        lambda: ConceptAttentionPipeline(MMDiT(tiny_mmdit_config())),
        lambda: MaskGenerator("teacher.npz"),
        lambda: TorchTextEncoders.random_init(0),
        lambda: VAE(VAEEncoder(vcfg), VAEDecoder(vcfg), vcfg),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_no_source_imports_jax_or_jax_modules():
    """No source of the port, and not chip_smoke.py, imports jax or any
    module of s3od_tpu, jax-free ones included: the port keeps its own
    copies."""
    pattern = re.compile(r"^\s*(import|from) (jax|s3od_tpu)\b", re.M)
    files = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert PKG / "datagen" / "diffusion.py" in files
    assert PKG / "models" / "mmdit.py" in files
    for name in ("ops/quant.py", "datagen/convert_flux.py",
                 "datagen/convert_text_encoders.py", "datagen/filtering.py",
                 "datagen/filters/vlm.py", "datagen/filters/consistency.py",
                 "datagen/run_filtering.py", "datagen/generate_metadata.py"):
        assert PKG / name in files
    hits = [str(f) for f in files if pattern.search(f.read_text())]
    assert not hits
    # transformers only inside a function (lazily), never at module level
    eager = re.compile(r"^(import|from) transformers\b", re.M)
    assert not [str(f) for f in files if eager.search(f.read_text())]


CARD_TESTS = sorted((REPO / "tests").glob("test_torch_*_cuda.py"))


def test_chip_smoke_names_no_module_of_the_jax_package():
    """The on-card command, the card's test files and their shared helper
    import nothing of jax or s3od_tpu; the command runs the card's tests
    through pytest, without conftest.py (which sets JAX up), and times
    nothing."""
    files = [REPO / "chip_smoke.py", REPO / "tests" / "_cuda.py", *CARD_TESTS]
    assert len(CARD_TESTS) >= 8
    for f in files:
        assert not re.search(r"^\s*(import|from) (jax|s3od_tpu)\b",
                             f.read_text(), re.M), f
    src = (REPO / "chip_smoke.py").read_text()
    assert "pytest.main" in src and "--noconftest" in src
    assert not re.search(r"perf_counter|profiler|Event\(|--turns", src)


def test_card_tests_live_in_their_own_files():
    """Every test marked for the card is in a `tests/test_torch_*_cuda.py`
    file, every test there takes the shared `cuda` fixture (which skips
    without a card) and carries the marker, and no other file of tests/
    names the marker."""
    import ast

    for f in CARD_TESTS:
        tree = ast.parse(f.read_text())
        assert any(isinstance(n, ast.ImportFrom) and n.module == "_cuda"
                   and "cuda" in [a.name for a in n.names] for n in tree.body), f
        assert re.search(r"^pytestmark = pytest\.mark\.cuda$", f.read_text(), re.M), f
        tests = [n for n in tree.body if isinstance(n, ast.FunctionDef)
                 and n.name.startswith("test_")]
        assert tests, f
        for t in tests:
            assert "cuda" in [a.arg for a in t.args.args], (f.name, t.name)

    def marks_cuda(f):
        return any(isinstance(n, ast.Attribute) and n.attr == "cuda"
                   and isinstance(n.value, ast.Attribute) and n.value.attr == "mark"
                   for n in ast.walk(ast.parse(f.read_text())))

    others = [f.name for f in (REPO / "tests").rglob("*.py")
              if f not in CARD_TESTS and marks_cuda(f)]
    assert not others


def test_build_dir_can_be_overridden(tmp_path, monkeypatch):
    from s3od_torch import _build

    monkeypatch.delenv("S3OD_TORCH_BUILD_DIR", raising=False)
    assert _build.build_dir() == REPO / "build" / "s3od_torch_kernels"
    monkeypatch.setenv("S3OD_TORCH_BUILD_DIR", str(tmp_path))
    assert _build.build_dir() == tmp_path


@pytest.mark.parametrize("caller", [None, "/elsewhere/triton"])
def test_triton_cache_is_scoped_to_the_launch(tmp_path, monkeypatch, caller):
    """Triton's cache points into the build directory only while the
    package's kernel launches; the caller's setting comes back after."""
    from s3od_torch import _build

    monkeypatch.setenv("S3OD_TORCH_BUILD_DIR", str(tmp_path))
    if caller is None:
        monkeypatch.delenv("TRITON_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("TRITON_CACHE_DIR", caller)
    with _build.triton_cache():
        assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / "triton")
    assert os.environ.get("TRITON_CACHE_DIR") == caller


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from s3od_torch import BackgroundRemoval

    with pytest.raises(RuntimeError, match="CUDA"):
        BackgroundRemoval("tests/fixture/tiny_s3od.npz", device="cuda")


def test_default_dtype_follows_the_device():
    from s3od_torch.ops.precision import default_dtype

    assert default_dtype(torch.device("cuda")) == torch.bfloat16
    assert default_dtype(torch.device("cpu")) == torch.float32


def test_kernel_build_hash_covers_every_source(tmp_path, monkeypatch):
    """The library is rebuilt whenever a source changes: the hash reads
    every csrc file, and the build directory is git-ignored."""
    from s3od_torch import _build

    srcs = {p.name for p in _build._sources()}
    assert {"mma.cuh", "hopper.cuh", "qkv_project.cu", "flash_attention.cu",
            "flash_attention_bwd.cu", "attn_epilogue.cu",
            "mlp_fused.cu", "flash_attention_online.cu", "winograd.cu",
            "mask_tail.cu", "exp_flash_variants.cu", "exp_loop.cu",
            "exp_layernorm.cu"} <= srcs
    h0 = _build.source_hash()
    for src in _build._sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.source_hash() == h0
    (tmp_path / "mma.cuh").write_text("// changed\n")
    assert _build.source_hash() != h0
    assert "build/" in (REPO / ".gitignore").read_text().split()
    assert set(_build._SIGNATURES) == {
        "s3od_qkv_project_rope", "s3od_flash_attention_fwd",
        "s3od_flash_attention_bwd", "s3od_attn_epilogue", "s3od_mlp_fused",
        "s3od_flash_attention_online_fwd", "s3od_winograd_conv",
        "s3od_winograd_rcu", "s3od_mask_tail", "s3od_exp_flash_fwd",
        "s3od_exp_loop", "s3od_ln_single_pass"}


FAKE_NVCC = """\
import sys, time
from pathlib import Path
args = sys.argv[1:]
out = Path(args[args.index("-o") + 1])
with open(Path(sys.argv[0]).parent / "calls.log", "a") as log:
    log.write(("link" if "-shared" in args else "compile") + "\\n")
if "-shared" in args:
    objs = [Path(a) for a in args if a.endswith(".o")]
    missing = [str(o) for o in objs if not o.exists()]
    if missing:
        sys.exit("missing objects: " + " ".join(missing))
else:
    time.sleep(0.3)
out.write_bytes(b"fake")
"""


def test_concurrent_first_loads_build_the_library_once(tmp_path, monkeypatch):
    """Stream workers may make the first launches together: every thread
    gets the one library, built by one nvcc per source and one link, with
    nvcc replaced by a stand-in that writes its output file."""
    import threading

    from s3od_torch import _build

    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(f"#!{sys.executable}\n" + FAKE_NVCC)
    nvcc.chmod(0o755)
    loaded = []

    class FakeLibrary:
        def __init__(self, path):
            loaded.append(path)
            for name in _build._SIGNATURES:
                setattr(self, name, type("Fn", (), {})())

    monkeypatch.setenv("S3OD_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLibrary)
    monkeypatch.setattr(_build, "_LIBRARY", None)
    start = threading.Barrier(4)
    libs, errors = [], []

    def first_launch():
        start.wait()
        try:
            libs.append(_build.load_library())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=first_launch) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors
    assert len(libs) == 4 and all(lib is libs[0] for lib in libs)
    calls = (nvcc.parent / "calls.log").read_text().split()
    assert calls.count("compile") == len(list(_build.CSRC.glob("*.cu")))
    assert calls.count("link") == 1 and len(loaded) == 1
    built = tmp_path / "build" / f"libs3od_kernels_{_build.source_hash()}.so"
    assert loaded == [str(built)] and built.read_bytes() == b"fake"
    assert not list((tmp_path / "build").glob("*.o"))


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
