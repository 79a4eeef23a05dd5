"""A device error propagates: no stage finishes quietly on the host.

Each case injects a failure at one device entry point that used to
catch errors and fall back to the host path, forces that stage's device
path (the CPU backend runs the same XLA programs), and requires the CLI
to raise it.  A last case checks that the command-line process exits
non-zero."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from alevin_fry_tpu.cli import main

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def rna(tmp_path_factory):
    """A small RNA dataset, permit-listed and collated on the host."""
    from synth_hard import make_hard_dataset

    d = tmp_path_factory.mktemp("rna")
    make_hard_dataset(d, np.random.RandomState(4), n_cells=40, n_reads=20_000,
                      n_genes=100)
    gpl = d / "gpl"
    assert main(["generate-permit-list", "-i", str(d / "rad"), "-d", "fw",
                 "-o", str(gpl), "-u", str(d / "permit.txt")]) == 0
    assert main(["collate", "-i", str(gpl), "-r", str(d / "rad")]) == 0
    return d


@pytest.fixture(scope="module")
def atac(tmp_path_factory):
    from synth_hard import make_hard_atac_dataset

    d = tmp_path_factory.mktemp("atac")
    make_hard_atac_dataset(d, np.random.RandomState(5), n_cells=40,
                           n_frags=10_000)
    gpl = d / "gpl"
    assert main(["atac", "generate-permit-list", "-i", str(d / "rad"), "-o",
                 str(gpl), "-u", str(d / "wl.txt"), "-m", "1", "-d", "rc"]) == 0
    assert main(["atac", "collate", "-i", str(gpl), "-r", str(d / "rad")]) == 0
    return d


def _boom(*a, **k):
    raise RuntimeError("injected device failure")


class _DeadPending:
    def get(self):
        _boom()


def _rna_argv(d, stage, out):
    gpl = str(d / "gpl")
    if stage == "gpl":
        return ["generate-permit-list", "-i", str(d / "rad"), "-d", "fw", "-o",
                str(out), "-u", str(d / "permit.txt")]
    if stage == "collate":
        # collate into a fresh copy of the permit-list outputs
        import shutil

        shutil.copytree(gpl, out)
        return ["collate", "-i", str(out), "-r", str(d / "rad")]
    res = {"crlike": "cr-like", "em": "cr-like-em", "pug": "parsimony"}[stage]
    return ["quant", "-i", gpl, "-m", str(d / "t2g.tsv"), "-o", str(out),
            "-r", res]


# site: (stage, env forcing the device path, (module, attr) to break,
#        replacement)
SITES = {
    "rescue": ("gpl", {"AFT_RESCUE_BACKEND": "jax"},
               ("alevin_fry_tpu.ops.rescue_device", "find_neighbors_searchsorted"),
               _boom),
    "gpl-histogram": ("gpl", {"AFT_GPL_MESH": "2"},
                      ("alevin_fry_tpu.parallel.mesh", "sharded_histogram"), _boom),
    "collate-shuffle": ("collate", {"AFT_COLLATE_BACKEND": "jax"},
                        ("alevin_fry_tpu.pipeline.collate", "collation_order_device"),
                        _boom),
    "wta-dispatch": ("crlike", {"AFT_CRLIKE_BACKEND": "jax", "AFT_WTA_ASYNC": "0"},
                     ("alevin_fry_tpu.ops.crlike_device",
                      "resolve_crlike_wta_device_packed"), _boom),
    "wta-async-fetch": ("crlike", {"AFT_CRLIKE_BACKEND": "jax"},
                        ("alevin_fry_tpu.ops.crlike_device",
                         "resolve_crlike_wta_device_packed"),
                        lambda *a, **k: _DeadPending()),
    "em": ("em", {"AFT_EM_BACKEND": "jax"},
           ("alevin_fry_tpu.ops.em", "_run_jax_buckets"), _boom),
    "pug-cc": ("pug", {"AFT_PUG_CC_BACKEND": "device"},
               ("alevin_fry_tpu.ops.pug_device", "connected_components_batched"),
               _boom),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_rna_device_failure_propagates(site, rna, tmp_path, monkeypatch):
    import importlib

    stage, env, (mod, attr), repl = SITES[site]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(importlib.import_module(mod), attr, repl)
    with pytest.raises(RuntimeError, match="injected device failure"):
        main(_rna_argv(rna, stage, tmp_path / "out"))


def test_atac_sort_failure_propagates(atac, monkeypatch):
    from alevin_fry_tpu.ops import atac_device

    monkeypatch.setenv("AFT_ATAC_SORT_BACKEND", "jax")
    monkeypatch.setattr(atac_device, "sort_rle_device", _boom)
    with pytest.raises(RuntimeError, match="injected device failure"):
        main(["atac", "sort", "-i", str(atac / "gpl"), "-r", str(atac / "rad")])


def test_cli_process_exits_nonzero(rna, tmp_path):
    """The command-line process ends with a non-zero status and the
    error on stderr."""
    code = (
        "import sys\n"
        "from alevin_fry_tpu.ops import em\n"
        "def boom(*a, **k):\n"
        "    raise RuntimeError('injected device failure')\n"
        "em._run_jax_buckets = boom\n"
        "from alevin_fry_tpu.cli import main\n"
        "sys.exit(main(sys.argv[1:]))\n"
    )
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "AFT_EM_BACKEND": "jax", "PYTHONPATH": str(REPO)}
    import os

    env.update({k: v for k, v in os.environ.items()
                if k in ("HOME", "TMPDIR", "XLA_FLAGS")})
    proc = subprocess.run(
        [sys.executable, "-c", code] + _rna_argv(rna, "em", tmp_path / "q"),
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert proc.returncode != 0
    assert "injected device failure" in proc.stderr
