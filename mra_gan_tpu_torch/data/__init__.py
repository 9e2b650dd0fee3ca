"""NIfTI IO and inference preprocessing: the port's own copies of
mra_gan_tpu/data/nifti.py and part of mra_gan_tpu/data/transforms.py."""
