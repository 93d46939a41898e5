"""Pluggable batched cost-model backends for the DSE evaluator (port of
``repro.core.costmodel``).

The evaluator in ``dse`` runs two stages: a PPA stage mapping a config
chunk to per-lane (power, clock, area), and the dataflow fold at the
clock the PPA stage produced.  A ``CostModel`` names the first stage's
function

    ppa_fn(params, config_chunk) -> (power_mw, clock_ghz, area_mm2)

with the fitted state it consumes and a host-side ``validate`` hook.

* ``"oracle"``: the analytical synthesis oracle, parameter-free.
* ``"surrogate"``: the fitted polynomial PPA models; needs ``models=``.

``as_cost_model`` resolves an evaluator's ``surrogate=`` argument:
``None`` is the oracle, a ``PPAModels`` wraps itself (cached on the
instance), a string hits the registry, a ``CostModel`` passes through.
Leakage is not part of the protocol: the evaluator derives it from area
with ``synth.LEAKAGE_MW_PER_MM2`` for every backend.
"""

from __future__ import annotations

from typing import Callable, Dict

from repro_torch.core.arch import AcceleratorConfig
from repro_torch.core.ppa import PPAModels, surrogate_ppa
from repro_torch.core.synth import oracle_ppa


class CostModel:
    """One batched PPA backend: a static function plus its parameters."""

    name: str = "?"
    ppa_fn: Callable = None

    @property
    def ppa_params(self):
        """The fitted state passed to ``ppa_fn`` (default: none)."""
        return ()

    def validate(self, cfg: AcceleratorConfig) -> None:
        """Host-side pre-check of a chunk (raise to refuse it)."""

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"


class OracleCostModel(CostModel):
    """The analytical synthesis oracle as a backend."""

    name = "oracle"
    ppa_fn = staticmethod(oracle_ppa)


class SurrogateCostModel(CostModel):
    """The fitted polynomial PPA models as a backend; ``validate`` refuses
    chunks holding PE types the fit does not cover."""

    name = "surrogate"
    ppa_fn = staticmethod(surrogate_ppa)

    def __init__(self, models: PPAModels):
        if not isinstance(models, PPAModels):
            raise TypeError(f"SurrogateCostModel needs a fitted PPAModels, "
                            f"got {type(models).__name__}")
        self.models = models
        self._params = models.ppa_params()  # also rejects an unfitted model

    @property
    def ppa_params(self):
        return self._params

    def validate(self, cfg: AcceleratorConfig) -> None:
        self.models.validate(cfg)


# ---------------------------------------------------------------------------
# Registry + resolution
# ---------------------------------------------------------------------------

COST_MODELS: Dict[str, Callable[..., CostModel]] = {}


def register_cost_model(name: str, factory: Callable[..., CostModel] | None
                        = None):
    """Register a backend factory under ``name`` (usable as decorator);
    re-registering a taken name is an error."""
    def _register(fn):
        if name in COST_MODELS:
            raise ValueError(f"cost model {name!r} is already registered")
        COST_MODELS[name] = fn
        return fn
    return _register(factory) if factory is not None else _register


def cost_model(name: str, **kwargs) -> CostModel:
    """Instantiate a registered backend by name."""
    if name not in COST_MODELS:
        raise ValueError(f"unknown cost model {name!r}; registered: "
                         f"{sorted(COST_MODELS)}")
    return COST_MODELS[name](**kwargs)


register_cost_model("oracle", OracleCostModel)


@register_cost_model("surrogate")
def _make_surrogate(models: PPAModels | None = None) -> SurrogateCostModel:
    if models is None:
        raise ValueError(
            "cost_model('surrogate') needs the fitted polynomial models: "
            "pass models=fit_ppa_models(...)")
    return SurrogateCostModel(models)


_ORACLE = OracleCostModel()


def as_cost_model(spec) -> CostModel:
    """Resolve an evaluator ``surrogate=`` spec to a ``CostModel``."""
    if spec is None:
        return _ORACLE
    if isinstance(spec, CostModel):
        return spec
    if isinstance(spec, PPAModels):
        cached = getattr(spec, "_cost_model", None)
        if cached is None or cached.models is not spec:
            cached = SurrogateCostModel(spec)
            spec._cost_model = cached
        return cached
    if isinstance(spec, str):
        return cost_model(spec)
    raise TypeError(
        f"cannot resolve a cost model from {type(spec).__name__}: pass "
        f"None (oracle), a fitted PPAModels, a CostModel, or a registered "
        f"backend name")
