"""Host-side data path of the port (numpy): the offline builder, the patch
sources (a built dataset on disk, or a scene in memory) and batching."""

from tomosar2height_tpu_torch.data.builder import build_dataset  # noqa: F401
from tomosar2height_tpu_torch.data.dataset import TomoSARDataset  # noqa: F401
from tomosar2height_tpu_torch.data.pipeline import (  # noqa: F401
    PatchLoader,
    loader_kwargs,
    pick_bucket,
    prefetch_depth,
    tile_cells_for_impl,
)
from tomosar2height_tpu_torch.data.scene import SceneDataset  # noqa: F401
