from photon_tpu_torch.utils.nrrd_io import read_nrrd, write_nrrd  # noqa: F401
from photon_tpu_torch.utils.tiff_io import write_tiff16, read_tiff16  # noqa: F401
from photon_tpu_torch.utils.rng import GlibcRand, lens_samples  # noqa: F401
