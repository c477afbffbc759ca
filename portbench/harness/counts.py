"""Operations and bytes from shapes, and the card's peaks.

Model FLOPs count each multiply-add of a convolution, dense layer or LSTM
gate product as two operations, at the precision the configuration runs
the layer in.  A backward pass costs twice its forward (the gradients of
the input and of the weights), except the first layer's, whose input (the
observation) needs no gradient: once.  Element-wise work is not counted.

An env step's bytes count each byte of the board, the goal board, the
initial board and the observation once, read or written, whatever kernels
do the step.
"""

# NVIDIA H100 SXM data sheet, dense: TFLOP/s by precision, HBM3 bytes/s.
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
PEAK_BYTES = 3.35e12


def layer_shapes(config):
    """[(layer, output positions, multiply-adds a position)] of one
    sample's forward pass."""
    h, w = config["view_shape"]
    c = config["channels"]
    out = []
    for layer in config["layers"]:
        kind = layer["kind"]
        if kind == "conv":
            k, s = layer["kernel"], layer["stride"]
            h, w = (h - k) // s + 1, (w - k) // s + 1
            out.append((layer, h * w, layer["out"] * k * k * c))
            c = layer["out"]
        elif kind == "dense":
            out.append((layer, 1, layer["in"] * layer["out"]))
        elif kind == "lstm":
            out.append((layer, 1, 4 * layer["units"]
                        * (layer["in"] + layer["units"])))
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
    return out


def forward_flops(config):
    """{precision: FLOPs} of one sample's forward pass."""
    flops = {}
    for layer, positions, macs in layer_shapes(config):
        p = layer["precision"]
        flops[p] = flops.get(p, 0) + 2 * positions * macs
    return flops


def train_flops(config, samples, epochs, rollout_samples):
    """{precision: FLOPs} of a PPO batch: the rollout's forward passes,
    then ``epochs`` forward and backward passes over ``samples``."""
    flops = {}
    for i, (layer, positions, macs) in enumerate(layer_shapes(config)):
        f = 2 * positions * macs
        backward = f if i == 0 else 2 * f
        total = rollout_samples * f + epochs * samples * (f + backward)
        flops[layer["precision"]] = flops.get(layer["precision"], 0) + total
    return flops


def least_seconds(flops):
    """The least time of ``flops`` ({precision: FLOPs}) at the peaks."""
    return sum(f / PEAK_FLOPS[p] for p, f in flops.items())


def env_step_bytes(board_hw, view, channels, batch):
    """Bytes of one env step of ``batch`` environments: three 16-bit
    boards and the uint8 observation."""
    h, w = board_hw
    return batch * (3 * h * w * 2 + view[0] * view[1] * channels)
