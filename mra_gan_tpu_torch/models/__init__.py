"""Networks, the CycleGAN and the model registry (counterpart of
mra_gan_tpu/models).

``find_model_using_name('foo_bar')`` imports ``mra_gan_tpu_torch.models.foo_bar``
and returns its class named ``FooBarConfig`` (the match ignores case and
underscores), as the JAX registry does (mra_gan_tpu/models/__init__.py:35-77).
A model injects its own flags through the class's
``modify_commandline_options(parser, is_train)``, which the options layer's
two-phase parse calls (``get_option_setter``)."""
import importlib

from .cycle_gan import CycleGANConfig

_MODELS = {}


def register_model(name):
    """Explicit registration decorator (also the discovery cache)."""

    def deco(cls):
        _MODELS[name] = cls
        return cls

    return deco


def find_model_using_name(name: str):
    """The config class of model ``name``: registered, or found by convention
    in ``mra_gan_tpu_torch/models/<name>.py``. KeyError when there is none."""
    if name in _MODELS:
        return _MODELS[name]
    try:
        module = importlib.import_module(f".{name}", __package__)
    except ImportError as e:
        raise KeyError(
            f"model [{name}] not registered and no module "
            f"mra_gan_tpu_torch/models/{name}.py exists ({e}); "
            f"registered: {sorted(_MODELS)}") from e
    target = name.replace("_", "") + "config"
    for attr, cls in vars(module).items():
        if isinstance(cls, type) and attr.lower() == target:
            _MODELS[name] = cls
            return cls
    raise KeyError(
        f"module mra_gan_tpu_torch/models/{name}.py defines no class named "
        f"~ {name.title().replace('_', '')}Config")


def get_option_setter(name: str):
    """The model's flag-injection hook, or None."""
    return getattr(find_model_using_name(name), "modify_commandline_options", None)


register_model("cycle_gan")(CycleGANConfig)
