"""Training flags (counterpart of mra_gan_tpu/options/train_options.py:5-76):
the same flags with the same defaults."""
from .base_options import BaseOptions


class TrainOptions(BaseOptions):
    def __init__(self):
        super().__init__()
        self.is_train = True

    def initialize(self, parser):
        parser = BaseOptions.initialize(self, parser)
        parser.add_argument("--print_freq", type=int, default=100,
                            help="iterations between console loss prints")
        parser.add_argument("--save_latest_freq", type=int, default=1000,
                            help="iterations between 'latest' checkpoint saves")
        parser.add_argument("--save_epoch_freq", type=int, default=200,
                            help="epochs between numbered checkpoint saves")
        parser.add_argument("--continue_train", action="store_true",
                            help="continue training: load the latest model")
        parser.add_argument("--epoch_count", type=int, default=1,
                            help="the starting epoch count")
        parser.add_argument("--phase", type=str, default="train")
        parser.add_argument("--which_epoch", type=str, default="latest",
                            help="which epoch to load (with --continue_train)")
        parser.add_argument("--niter", type=int, default=500,
                            help="# of epochs at the starting learning rate")
        parser.add_argument("--niter_decay", type=int, default=100,
                            help="# of epochs to linearly decay learning rate to zero")
        parser.add_argument("--beta1", type=float, default=0.5, help="momentum term of adam")
        parser.add_argument("--lr", type=float, default=0.0002,
                            help="initial learning rate for adam")
        # The reference's inverted flag (store_false): the default
        # no_lsgan=True trains vanilla GAN with a sigmoid discriminator;
        # passing --no_lsgan selects least-squares GAN.
        parser.add_argument("--no_lsgan", action="store_false",
                            help="switch to least-squares GAN (the default, like the "
                                 "reference's, is vanilla GAN + sigmoid D)")
        parser.add_argument("--pool_size", type=int, default=50,
                            help="size of the generated-image replay buffer")
        parser.add_argument("--lr_policy", type=str, default="lambda",
                            help="lambda | step | plateau | cosine")
        parser.add_argument("--lr_decay_iters", type=int, default=50,
                            help="decay LR by 0.1 every lr_decay_iters epochs (step policy)")
        parser.add_argument("--profile_dir", type=str, default="",
                            help="write a torch.profiler Chrome trace of the first epoch here")
        parser.add_argument("--augment", action="store_true",
                            help="the reference's random augmentation of each patch pair "
                                 "on the device (one of 8 choices per sample)")
        parser.add_argument("--augment_extended", action="store_true",
                            help="with --augment: also draw the reference's unreachable "
                                 "choices 8-12 (translate, single-axis rotations, gamma)")
        parser.add_argument("--remat", action="store_true",
                            help="recompute the generators' activations in the backward "
                                 "(less peak memory for more step time)")
        parser.add_argument("--dump_patches", type=int, default=0,
                            help="write the first N sampled patch pairs of the run to "
                                 "<checkpoints>/<name>/patch_dumps/ as .nii.gz")
        parser.add_argument("--no_mem_check", action="store_true",
                            help="skip the device-memory preflight of the train step "
                                 "(two trial steps, core/memory.py)")
        parser.add_argument("--hbm_limit_gib", type=float, default=0.0,
                            help="device memory budget of the preflight in GiB (0 = the "
                                 "card's total memory)")
        return parser
