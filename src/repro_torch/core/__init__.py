"""The paper's contribution: season- and trend-aware symbolic approximation
(sSAX / tSAX) with lower-bounding distances, plus the SAX baseline and
the pruned exact / approximate matching engine.  The split-tree index
lives in ``repro_torch.index`` (``core.index`` is its compatibility
shim)."""

from repro_torch.core.normalize import znormalize  # noqa: F401
from repro_torch.core.breakpoints import (  # noqa: F401
    gaussian_breakpoints, uniform_breakpoints, discretize)
from repro_torch.core.paa import paa, paa_distance  # noqa: F401
from repro_torch.core.sax import SAX  # noqa: F401
from repro_torch.core.ssax import (  # noqa: F401
    SSAX, season_mask, season_strength)
from repro_torch.core.tsax import (  # noqa: F401
    TSAX, trend_features, trend_strength)
from repro_torch.core.stsax import STSAX  # noqa: F401
from repro_torch.core.onedsax import OneDSAX  # noqa: F401
from repro_torch.core.techniques import (  # noqa: F401
    TECHNIQUES, from_reference, make_technique, rep_from_numpy)
from repro_torch.core.matching import (  # noqa: F401
    exact_match, approximate_match, euclidean)
from repro_torch.core.engine import (  # noqa: F401
    MatchEngine, TopKResult, topk_verify, verify_candidates)
