"""The port's flag registry, config mapping and run-dir protocol
(sqair_tpu_torch/experiment/) held to the JAX package's: every flag of the
JAX CLI and of the configs the port has, with its type and default; the
release flags.json; the numbered run dirs; resume with command-line flags
winning and persisting; the mapping of the JAX package's config paths.
"""
import json
import os
import shutil
import subprocess
import sys

import pytest

from sqair_tpu.experiment import experiment_tools as jtools
from sqair_tpu.experiment import flags as jflags
from sqair_tpu_torch.configs import mlp_mnist_model
from sqair_tpu_torch.experiment import experiment_tools as ptools
from sqair_tpu_torch.experiment import flags as pflags
import sqair_tpu_torch.configs.synth_seq_mnist_data  # noqa: F401  (the release run's flags)
import sqair_tpu_torch.scripts.experiment  # noqa: F401  (defines the CLI's flags)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELEASE_FLAGS = os.path.join(REPO, "release_models", "mnist_mlp", "1", "flags.json")
CONFIGS = ("mlp_mnist_model", "conv_mnist_model", "synth_seq_mnist_data", "font_seq_mnist_data",
           "seq_mnist_data")
# the port's flags that the JAX package has not
PORT_ONLY = {"device"}

# both registries in a fresh interpreter: the flags of the CLI and of the
# configs the port has, (type name, default) by name
_DUMP = """
import importlib, json, sys
pkg = sys.argv[1]
for m in ["scripts.experiment"] + ["configs." + c for c in {configs!r}]:
    importlib.import_module(pkg + "." + m)
flags = importlib.import_module(pkg + ".experiment.flags")
print(json.dumps({{n: [t.__name__, d] for n, (t, d, _) in flags.FLAGS._defs.items()}}))
"""


@pytest.fixture
def clean_registries():
    """Both registries' values (and sys.argv) as they were before the test."""
    saved = [(f.FLAGS, dict(f.FLAGS._values), set(f.FLAGS._cli_set)) for f in (jflags, pflags)]
    argv = sys.argv
    pflags.reset()
    yield
    sys.argv = argv
    for registry, values, cli in saved:
        registry._values.clear()
        registry._values.update(values)
        registry._cli_set.clear()
        registry._cli_set.update(cli)


def _registry(pkg):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _DUMP.format(configs=CONFIGS), pkg], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_jax_flag_has_its_type_and_default_in_the_port():
    want, got = _registry("sqair_tpu"), _registry("sqair_tpu_torch")
    assert set(got) - set(want) == PORT_ONLY
    assert {n: got[n] for n in want} == want


def test_model_defaults_are_the_flags_defaults():
    """``mlp_mnist_model.DEFAULTS`` and ``TRAIN_DEFAULTS`` are the defaults
    the flags were defined with (one source)."""
    for name, default in mlp_mnist_model.DEFAULTS.items():
        ftype, defined, _ = pflags.FLAGS._defs[name]
        assert defined == default or name == "output_std", name  # the data configs retune it
        assert isinstance(default, ftype), name
    assert mlp_mnist_model.DEFAULTS["output_std"] == 0.3
    for name, default in mlp_mnist_model.TRAIN_DEFAULTS.items():
        assert pflags.FLAGS._defs[name][1] == default, name
    from sqair_tpu_torch.configs import conv_mnist_model

    assert conv_mnist_model.CONV_DEFAULTS == dict(conv_kernel=3, conv_channels="32,64")
    for name, default in conv_mnist_model.CONV_DEFAULTS.items():
        assert pflags.FLAGS._defs[name][:2] == (type(default), default), name


def test_release_flags_json_loads_and_round_trips(tmp_path, clean_registries):
    run = tmp_path / "run"
    (run / "1").mkdir(parents=True)
    shutil.copyfile(RELEASE_FLAGS, run / "1" / "flags.json")
    with open(RELEASE_FLAGS) as f:
        release = json.load(f)
    sys.argv = ["x"]
    logdir, flags, ckpt = ptools.init_checkpoint(str(run), release["data_config"],
                                                 release["model_config"], resume=True)
    assert logdir == str(run / "1") and ckpt is None
    for name, value in release.items():
        assert flags[name] == value, name
        if name != "git_commit":
            assert isinstance(value, pflags.FLAGS._defs[name][0]), name
    with open(run / "1" / "flags.json") as f:
        assert json.load(f) == release  # nothing overridden: not rewritten
    ptools.json_store(str(tmp_path / "again.json"), flags)
    assert ptools.json_load(str(tmp_path / "again.json")) == flags
    model = mlp_mnist_model.load(flags, (50, 50), device="cpu")
    assert model.k_particles == 5
    assert mlp_mnist_model.train_settings(flags)["train_itr"] == 1000000


def test_null_flags_take_their_defaults(tmp_path, clean_registries):
    """A flags.json that predates a flag may hold null for it."""
    with open(RELEASE_FLAGS) as f:
        release = json.load(f)
    release.update(coverage_lr_mult=None, disc_coverage_signal=None)
    (tmp_path / "run" / "1").mkdir(parents=True)
    ptools.json_store(str(tmp_path / "run" / "1" / "flags.json"), release)
    sys.argv = ["x"]
    _, flags, _ = ptools.init_checkpoint(str(tmp_path / "run"), release["data_config"],
                                         release["model_config"], resume=True)
    assert flags["coverage_lr_mult"] == 1.0 and flags["disc_coverage_signal"] is False
    mlp_mnist_model.load(dict(release, n_units=1), (50, 50), device="cpu")


def test_numbered_run_dirs_match_jax(tmp_path, clean_registries):
    data, model = "sqair_tpu/configs/synth_seq_mnist_data.py", "sqair_tpu/configs/mlp_mnist_model.py"
    made = {}
    for name, tools in (("jax", jtools), ("port", ptools)):
        root = tmp_path / name
        for d in ("1", "3", "_7", "abc"):
            (root / d).mkdir(parents=True)
        runs = []
        for _ in range(2):
            sys.argv = ["x", "--n_units=4"]
            runs.append(os.path.basename(tools.init_checkpoint(str(root), data, model, False)[0]))
        made[name] = (runs, sorted(os.listdir(root)), sorted(os.listdir(root / runs[0])))
    assert made["port"] == made["jax"]
    assert made["port"][0] == ["4", "5"]
    with open(tmp_path / "port" / "4" / "flags.json") as f:
        assert json.load(f)["n_units"] == 4


def test_resume_cli_flags_override_snapshot(tmp_path, clean_registries):
    data, model = "sqair_tpu/configs/synth_seq_mnist_data.py", "sqair_tpu/configs/mlp_mnist_model.py"
    sys.argv = ["x", "--train_itr=100"]
    logdir, first, _ = ptools.init_checkpoint(str(tmp_path / "run"), data, model, resume=False)
    assert first["train_itr"] == 100
    pflags.reset()
    sys.argv = ["x", "--train_itr=200"]
    logdir2, second, _ = ptools.init_checkpoint(str(tmp_path / "run"), data, model, resume=True)
    assert logdir2 == logdir and second["train_itr"] == 200
    assert second["batch_size"] == first["batch_size"]
    assert ptools.json_load(os.path.join(logdir, "flags.json"))["train_itr"] == 200
    with pytest.raises(ValueError, match="doesn't exist"):
        ptools.init_checkpoint(str(tmp_path / "nothing"), data, model, resume=True)


def test_attach_joins_the_newest_run_dir_and_writes_nothing(tmp_path, clean_registries):
    """The counterpart of JAX's ``attach=True``: a process other than 0 of a
    multi-process run joins process 0's run dir, resuming or not, and
    writes nothing, not even flags.json when its command line differs."""
    data, model = "sqair_tpu/configs/synth_seq_mnist_data.py", "sqair_tpu/configs/mlp_mnist_model.py"
    root = str(tmp_path / "run")
    with pytest.raises(ValueError, match="attach"):
        ptools.init_checkpoint(root, data, model, resume=False, attach=True)
    sys.argv = ["x", "--train_itr=100"]
    made, _, _ = ptools.init_checkpoint(root, data, model, resume=False)
    before = {n: open(os.path.join(made, n)).read() for n in os.listdir(made)}
    for resume, argv in ((False, ["x", "--train_itr=100"]), (True, ["x", "--train_itr=300"])):
        pflags.reset()
        sys.argv = argv
        joined, flags, ckpt = ptools.init_checkpoint(root, data, model, resume=resume,
                                                     attach=True)
        assert joined == made and ckpt is None
        assert sorted(os.listdir(root)) == ["1"]
        assert {n: open(os.path.join(made, n)).read() for n in os.listdir(made)} == before
    assert flags["train_itr"] == 300  # resuming, it reads the run's flags as process 0 does
    open(os.path.join(made, "ckpt-7"), "w").close()
    assert ptools.init_checkpoint(root, data, model, resume=False, attach=True)[2].endswith(
        "ckpt-7")


def test_a_resume_with_unchanged_flags_writes_no_flags_json(tmp_path, clean_registries):
    """``--resume`` (and where the run lives, and on which device and
    coordinator) is no change of the run's flags: flags.json stays as it
    was; a flag that changes what the run computes is persisted."""
    data, model = "sqair_tpu/configs/synth_seq_mnist_data.py", "sqair_tpu/configs/mlp_mnist_model.py"
    results = str(tmp_path / "results")
    sys.argv = ["x", "--train_itr=100", f"--results_dir={results}", "--run_name=a"]
    logdir, _, _ = ptools.init_checkpoint(os.path.join(results, "a"), data, model, resume=False)
    path = os.path.join(logdir, "flags.json")
    os.utime(path, (1, 1))
    pflags.reset()
    sys.argv = ["x", "--resume", f"--results_dir={results}", "--run_name=a", "--device=cpu",
                "--coordinator_address=127.0.0.1:1234", "--process_id=0", "--train_itr=100"]
    ptools.init_checkpoint(os.path.join(results, "a"), data, model, resume=True)
    assert os.stat(path).st_mtime == 1
    assert ptools.json_load(path)["resume"] is False
    pflags.reset()
    sys.argv = ["x", "--resume", "--train_itr=200"]
    ptools.init_checkpoint(os.path.join(results, "a"), data, model, resume=True)
    assert ptools.json_load(path)["train_itr"] == 200


def test_run_device_reads_the_newest_run_dirs_flags(tmp_path):
    """A resume's device, known before its flags are restored: the newest
    run dir's flags.json's, else the default."""
    root = tmp_path / "run"
    assert ptools.run_device(str(root), "cuda") == "cuda"
    for n, device in ((1, "cuda"), (2, "cpu")):
        (root / str(n)).mkdir(parents=True)
        ptools.json_store(str(root / str(n) / "flags.json"), dict(device=device))
    (root / "10").mkdir()
    assert ptools.run_device(str(root), "cuda") == "cuda"  # run 10 has no flags.json yet
    ptools.json_store(str(root / "10" / "flags.json"), dict(device="cpu"))
    assert ptools.run_device(str(root), "cuda") == "cpu"


@pytest.mark.parametrize("given, module", [
    ("sqair_tpu/configs/mlp_mnist_model.py", "sqair_tpu_torch.configs.mlp_mnist_model"),
    ("./sqair_tpu/configs/../configs/font_seq_mnist_data.py",
     "sqair_tpu_torch.configs.font_seq_mnist_data"),
    ("sqair_tpu_torch/configs/seq_mnist_data.py", "sqair_tpu_torch.configs.seq_mnist_data"),
    ("sqair_tpu.configs.synth_seq_mnist_data", "sqair_tpu_torch.configs.synth_seq_mnist_data"),
    ("sqair_tpu/configs/pedestrian_model.py", "sqair_tpu_torch.configs.pedestrian_model"),
    ("sqair_tpu.configs.small_digit_seq_mnist_data",
     "sqair_tpu_torch.configs.small_digit_seq_mnist_data"),
    ("sqair_tpu/configs/conv_mnist_model.py", "sqair_tpu_torch.configs.conv_mnist_model"),
    ("sqair_tpu.configs.conv_mnist_model", "sqair_tpu_torch.configs.conv_mnist_model"),
])
def test_jax_config_paths_map_to_the_port(given, module):
    assert ptools.resolve_config(given) == module
    loaded = ptools._import_module(given)
    assert loaded.__name__ == module and "sqair_tpu_torch" in loaded.__file__


@pytest.mark.parametrize("given", ["sqair_tpu/data/loader.py", "sqair_tpu.data.loader"])
def test_jax_paths_without_a_counterpart_raise(given):
    with pytest.raises(ValueError, match="counterpart"):
        ptools.resolve_config(given)


def test_a_config_file_outside_both_packages_is_imported_from_its_path(tmp_path):
    path = tmp_path / "my_port_config.py"
    path.write_text("def load(*args):\n    return ('loaded', args)\n")
    assert ptools.resolve_config(str(path)) == str(path)
    assert ptools.load(str(path), 3) == ("loaded", (3,))
