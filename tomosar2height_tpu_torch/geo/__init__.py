"""Host-side geo code (float64 numpy): point transforms, bbox crops, the
GeoTIFF codec and rasters, mask dilation and point-cloud files.

Counterpart of ``tomosar2height_tpu/geo/``, with the same arithmetic, so
patches, pixel origins, read arrays and written files are bit-identical to
the JAX package's (``tests/test_torch_geo.py``, ``tests/test_torch_geo_io.py``).
"""

from tomosar2height_tpu_torch.geo.cloud import (  # noqa: F401
    load_las_as_numpy,
    load_pc,
    load_ply,
    save_las,
    save_pc_to_ply,
)
from tomosar2height_tpu_torch.geo.crop import GridIndex2D, crop_pc_2d  # noqa: F401
from tomosar2height_tpu_torch.geo.mask import dilate_mask  # noqa: F401
from tomosar2height_tpu_torch.geo.raster import (  # noqa: F401
    RasterData,
    RasterReader,
    write_geotiff,
)
from tomosar2height_tpu_torch.geo.tiff import read_tiff  # noqa: F401
from tomosar2height_tpu_torch.geo.transform import (  # noqa: F401
    FLIP_MATRICES,
    ROT_MATRICES,
    Affine,
    apply_transform,
    invert_transform,
)
