"""K10, the volume's gradient precompute (``csrc/volume_prep.cu``,
``gradient_tile_kernel``): a voxel's n - 1 read once (4 bytes) and its
packed (grad n, n - 1) written once (16 bytes); its differences are far
under the bytes' time."""

TAG = "gradient_tile_kernel"
COUNTER = ("photon_tpu_torch.native", "launch_gradient_field")


def work(shape):
    return 0, 20 * shape["voxels"]
