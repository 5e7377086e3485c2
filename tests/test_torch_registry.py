"""The port's model registry (utils/registry.py) against the JAX
package's: every name the reference registers (its built-ins and the
families whose modules register themselves) resolves in the port, to an
entry with the reference's functions. Importing the registry imports no
model; a name resolves on first use."""

import subprocess
import sys

import pytest

from metatransformer_tpu.models import (  # noqa: F401 (their imports register them)
    baafnet, curvenet, point_baselines, point_baselines2, point_baselines3, point_mae,
    point_transformer_seg, randlanet, simpleview, stratified_transformer,
)
from metatransformer_tpu.utils.registry import MODELS as JMODELS
from metatransformer_tpu_torch.utils.registry import MODELS, Registry

JAX_NAMES = sorted(JMODELS._entries)


def test_builtin_models_registered():
    for name in ("ImageClassifier", "AudioClassifier", "VideoClassifier", "PointClassifier",
                 "PointSegmenter", "HyperClassifier", "TabularClassifier", "GraphPredictor",
                 "TimeSeriesModel"):
        assert name in MODELS
        mod = MODELS.get(name)
        assert hasattr(mod, "init") and hasattr(mod, "forward")


@pytest.mark.parametrize("name", JAX_NAMES)
def test_every_reference_name_resolves_or_names_its_item(name):
    """Every family is ported: no name is left to raise naming its item."""
    assert name in MODELS
    entry, ref = MODELS.get(name), JMODELS.get(name)
    for attr in ("init", "forward", "forward_train", "training_loss", "predict"):
        assert hasattr(entry, attr) == hasattr(ref, attr), attr
    if hasattr(ref, "Config"):
        assert entry.Config.__name__ == ref.Config.__name__


def test_the_port_knows_no_name_the_reference_does_not():
    assert set(MODELS.known()) <= set(JAX_NAMES)


def test_registry_build_and_errors():
    reg = Registry("test")

    @reg.register()
    def make_thing(a, b=2):
        return a + b

    assert reg.build({"NAME": "make_thing", "a": 1}) == 3
    assert reg.build({"name": "make_thing", "a": 1, "b": 10}) == 11
    with pytest.raises(KeyError):
        reg.get("missing")
    with pytest.raises(KeyError):

        @reg.register("make_thing")
        def dup():
            pass


def test_the_point_mae_hook_registers_its_model():
    from metatransformer_tpu_torch.models import point_mae

    entry = MODELS.get("MaskedPointViT")
    assert entry.init is point_mae.init and entry.Config is point_mae.MaskedPointViTConfig


def test_importing_the_registry_imports_no_model():
    code = ("import sys\n"
            "from metatransformer_tpu_torch.utils.registry import MODELS\n"
            "prefix = 'metatransformer_tpu_torch.models.'\n"
            "print(sorted(m for m in sys.modules if m.startswith(prefix)))\n"
            "MODELS.get('PointNeXt')\n"
            "print('metatransformer_tpu_torch.models.point_baselines' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.split("\n")[:2] == ["[]", "True"]
