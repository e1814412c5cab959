from s3od_torch.datagen.filters.consistency import HorizontalFlipConsistencyFilter
from s3od_torch.datagen.filters.vlm import GemmaMaskArtifactFilter, GemmaSemanticFilter

__all__ = [
    "HorizontalFlipConsistencyFilter",
    "GemmaSemanticFilter",
    "GemmaMaskArtifactFilter",
]
