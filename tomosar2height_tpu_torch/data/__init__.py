"""Host-side data path of the port (numpy): serving patches and batching."""

from tomosar2height_tpu_torch.data.pipeline import (  # noqa: F401
    PatchLoader,
    pick_bucket,
    tile_cells_for_impl,
)
from tomosar2height_tpu_torch.data.scene import SceneDataset  # noqa: F401
