"""CLI flag group for BlockCopy settings (counterpart of
``blockcopy_tpu/core/argparser.py``).

The flags mirror the reference's one for one; the settings dict keys are the
contract read by ``build_policy_from_settings`` and ``BlockCopyModel``.
"""

from __future__ import annotations

POLICY_CHOICES = [
    "static",
    "all",
    "none",
    "random",
    "rl_semseg",
    "rl_objectdetection",
]


def add_argparser_arguments(parser):
    parser.add_argument(
        "--block-policy", type=str, default="rl_semseg", choices=POLICY_CHOICES,
        help="policy name",
    )
    parser.add_argument(
        "--block-num-classes", type=int, default=19,
        help="number of output classes of the main task",
    )
    parser.add_argument("--block-optim-lr", type=float, default=0.0001,
                        help="policy learning rate")
    parser.add_argument("--block-optim-wd", type=float, default=0.001,
                        help="policy weight decay")
    parser.add_argument("--block-optim-momentum", type=float, default=0,
                        help="policy optimizer momentum")
    parser.add_argument("--block-target", type=float, default=0.50,
                        help="target execution percentage")
    parser.add_argument(
        "--block-complexity-weight", type=float, default=5,
        help="weight gamma, setting importance of complexity reward",
    )
    parser.add_argument("--block-size", type=int, default=128,
                        help="size of blocks in px")
    parser.add_argument("--block-train-interval", type=int, default=4,
                        help="optimize the policy every N frames")
    parser.add_argument("--block-cost-momentum", type=float, default=0.9,
                        help="cost momentum")
    parser.add_argument("--block-policy-verbose", action="store_true",
                        help="print debug info for policy training")
    parser.add_argument(
        "--block-policy-arch", type=str, default="ref",
        choices=["ref", "fast"],
        help="policy net architecture: 'ref' = the reference PolicyNet, "
        "'fast' = space-to-depth trunk with the same REINFORCE machinery",
    )
    return parser


def default_settings(**overrides) -> dict:
    """Settings dict with the argparser's defaults (for library and test use
    without a CLI)."""
    s = dict(
        block_policy="rl_semseg",
        block_num_classes=19,
        block_optim_lr=0.0001,
        block_optim_wd=0.001,
        block_optim_momentum=0.0,
        block_target=0.50,
        block_complexity_weight=5.0,
        block_size=128,
        block_train_interval=4,
        block_cost_momentum=0.9,
        block_policy_verbose=False,
        block_policy_arch="ref",
        block_quantize_number_exec=1.0 / 16.0,
    )
    s.update(overrides)
    return s
