"""Contract types of the port: :class:`AnchorConfig`, :class:`AttentionSpec`."""

from repro_torch.core.config import PAPER_CONFIG, AnchorConfig
from repro_torch.core.spec import AttentionSpec

__all__ = ["AnchorConfig", "AttentionSpec", "PAPER_CONFIG"]
