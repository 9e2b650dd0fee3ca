"""The 'test' model's flags (counterpart of mra_gan_tpu/models/test.py):
the CycleGAN's inference flags and ``--model_suffix``, found by the registry
under the name 'test'. The decode itself is ``mra_gan_tpu_torch.test``."""
from __future__ import annotations

from .cycle_gan import CycleGANConfig


class TestConfig:
    __test__ = False  # not a pytest class

    @staticmethod
    def modify_commandline_options(parser, is_train: bool):
        if is_train:
            raise ValueError("the 'test' model cannot be used in train mode")
        parser = CycleGANConfig.modify_commandline_options(parser, is_train=False)
        parser.add_argument("--model_suffix", type=str, default="_A",
                            help="which saved generator to run: _A (A->B) or _B (B->A)")
        return parser
