"""Declarative tenant-policy model for multi-tenant QoS.

The port's own copy of ``oim_tpu/qos/policy.py`` (pure Python, so the
copy is verbatim but for this paragraph
and two phrases).  The engine takes a policy as ``Engine(qos=...)`` or
``set_qos_policy`` (``serve_main --qos-policy FILE`` through
:func:`load_policy_file`); with none loaded it reads
:data:`DEFAULT_POLICY`'s tiers, which order park victims and stamp a
migrated slot's manifest.

One policy document answers every "may this tenant ..." question the
serving plane asks:

- **tier** — ``premium`` / ``standard`` / ``best_effort``.  The tier
  carries the defaults for everything below, plus the two tier-global
  behaviors: preemption priority (a higher-priority tenant's admission
  may park a strictly-lower-priority tenant's slot) and prefix pinning
  (premium prefix-cache entries never demote to the host tier while a
  lower tier's entry can go instead).
- **weight** — the tenant's share of engine admission under
  contention.  The engine's fair-share scheduler is virtual-time
  (stride) based: each admission advances the tenant's vtime by
  ``tokens / weight``, and the queue head with the LEAST vtime admits
  next — so over time token throughput converges to the weight ratio
  regardless of who queues faster.
- **rate_rps / tokens_per_s** (+ bursts) — router-side token buckets.
  Exceeding either sheds the request at the door with 429 and a
  per-tenant Retry-After (the shed taxonomy's reason
  ``quota``) — cheap rejection before any accelerator state is touched.

The document lives in the registry under :data:`QOS_TENANTS_KEY`
(operator-published, see :mod:`oim_tpu.qos.publish`) with a static-file
fallback for registry-less deployments.  Decode is TOLERANT the same
way ``autoscale/load.decode_load`` is: unknown fields are ignored,
wrong-typed fields fall back to defaults, and a torn/foreign value
yields the all-defaults policy — a bad publish degrades to "no QoS",
never to a crashed data plane.

Identity fallback: requests with no mTLS peer
CN all collapse into the ``"anon"`` tenant.  Without a policy that is
one shared identity consuming every tier's headroom, so anon gets an
EXPLICIT default tier (``anon_tier``, best-effort) distinct from the
default for unknown-but-authenticated CNs (``default_tier``,
standard).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

# Registry key the operator publishes the policy document under
# (authz: registry/authz.py grants it to user.admin explicitly).
QOS_TENANTS_KEY = "qos/tenants"

ANON_TENANT = "anon"

# Tier order is privilege order (most to least).  ``best_effort`` is
# spelled with an underscore everywhere (metric label values, JSON) —
# decode normalizes "best-effort" for operator convenience.
TIERS = ("premium", "standard", "best_effort")

# Tier defaults: admission weight (fair-share stride denominators) and
# preemption priority (an admission may park only a STRICTLY lower
# priority victim — equal tiers never preempt each other, so a
# policy-less fleet behaves exactly as before this PR).
TIER_WEIGHT = {"premium": 8.0, "standard": 4.0, "best_effort": 1.0}
TIER_PRIORITY = {"premium": 2, "standard": 1, "best_effort": 0}


def _normalize_tier(value, default: str) -> str:
    if not isinstance(value, str):
        return default
    tier = value.strip().lower().replace("-", "_")
    return tier if tier in TIERS else default


@dataclass(frozen=True)
class TenantPolicy:
    """One tenant's resolved policy (defaults already applied)."""

    tenant: str
    tier: str = "standard"
    # 0 means "tier default" for every numeric knob; rate/quota knobs
    # additionally mean "unlimited" when the tier default is also 0
    # (the built-in tiers impose no caps — caps are per-tenant policy).
    weight: float = 0.0
    rate_rps: float = 0.0  # request-rate bucket refill (0 = unlimited)
    rate_burst: float = 0.0  # bucket depth (0 → max(1, rate_rps))
    tokens_per_s: float = 0.0  # token-quota bucket refill (0 = unlimited)
    token_burst: float = 0.0  # bucket depth (0 → 16 × tokens_per_s)

    @property
    def effective_weight(self) -> float:
        if self.weight > 0:
            return self.weight
        return TIER_WEIGHT.get(self.tier, 1.0)

    @property
    def priority(self) -> int:
        return TIER_PRIORITY.get(self.tier, 0)

    @property
    def pin_prefix(self) -> bool:
        """Premium prefix-cache entries pin against host-tier demotion
        and eviction while any lower-tier victim exists."""
        return self.tier == "premium"

    @property
    def effective_rate_burst(self) -> float:
        if self.rate_burst > 0:
            return self.rate_burst
        return max(1.0, self.rate_rps)

    @property
    def effective_token_burst(self) -> float:
        if self.token_burst > 0:
            return self.token_burst
        return 16.0 * self.tokens_per_s


_TENANT_FIELDS = (
    ("weight", 0.0),
    ("rate_rps", 0.0),
    ("rate_burst", 0.0),
    ("tokens_per_s", 0.0),
    ("token_burst", 0.0),
)


@dataclass(frozen=True)
class QosPolicy:
    """The whole fleet's tenant policy: per-tenant rows + the two
    fallback tiers.  Immutable — engines/routers swap the reference
    atomically on policy reload."""

    tenants: dict = field(default_factory=dict)  # tenant → TenantPolicy
    default_tier: str = "standard"  # unknown but authenticated CNs
    anon_tier: str = "best_effort"  # the no-mTLS identity sink

    def lookup(self, tenant: str) -> TenantPolicy:
        """The resolved policy for ``tenant`` — synthesizes a
        tier-default row for tenants with no explicit entry, so callers
        never branch on presence."""
        name = tenant or ANON_TENANT
        entry = self.tenants.get(name)
        if entry is not None:
            return entry
        tier = self.anon_tier if name == ANON_TENANT else self.default_tier
        return TenantPolicy(tenant=name, tier=tier)

    def tier_of(self, tenant: str) -> str:
        return self.lookup(tenant).tier


#: The policy a fleet runs with when nothing was published: every
#: authenticated tenant standard, anon best-effort, no caps — fair
#: share is a no-op between equal weights and nothing throttles.
DEFAULT_POLICY = QosPolicy()


def decode_policy(text) -> QosPolicy:
    """Tolerant decode of a policy document (JSON text or bytes).

    Never raises: a torn, foreign or wrong-shaped value yields
    :data:`DEFAULT_POLICY`; per-field damage falls back per field.  The
    mirror of ``autoscale/load.decode_load`` — schema skew between
    fleet generations must degrade, not crash.
    """
    if isinstance(text, bytes):
        try:
            text = text.decode()
        except UnicodeDecodeError:
            return DEFAULT_POLICY
    if not text or not isinstance(text, str):
        return DEFAULT_POLICY
    try:
        doc = json.loads(text)
    except ValueError:
        return DEFAULT_POLICY
    if not isinstance(doc, dict):
        return DEFAULT_POLICY
    default_tier = _normalize_tier(doc.get("default_tier"), "standard")
    anon_tier = _normalize_tier(doc.get("anon_tier"), "best_effort")
    tenants: dict[str, TenantPolicy] = {}
    rows = doc.get("tenants")
    if isinstance(rows, dict):
        for name, row in rows.items():
            if not isinstance(name, str) or not name:
                continue
            if not isinstance(row, dict):
                row = {}
            kwargs = {}
            for key, default in _TENANT_FIELDS:
                value = row.get(key, default)
                # int is acceptable where float is expected (JSON
                # writers emit 5, not 5.0) — the decode_load leniency.
                if isinstance(value, bool) or not isinstance(
                    value, (int, float)
                ):
                    value = default
                kwargs[key] = max(0.0, float(value))
            tenants[name] = TenantPolicy(
                tenant=name,
                tier=_normalize_tier(row.get("tier"), default_tier),
                **kwargs,
            )
    return QosPolicy(
        tenants=tenants, default_tier=default_tier, anon_tier=anon_tier
    )


def encode_policy(policy: QosPolicy) -> str:
    """The inverse of :func:`decode_policy` — what
    ``oim_tpu.qos.publish`` writes under ``qos/tenants``."""
    return json.dumps({
        "default_tier": policy.default_tier,
        "anon_tier": policy.anon_tier,
        "tenants": {
            name: {
                "tier": row.tier,
                "weight": row.weight,
                "rate_rps": row.rate_rps,
                "rate_burst": row.rate_burst,
                "tokens_per_s": row.tokens_per_s,
                "token_burst": row.token_burst,
            }
            for name, row in sorted(policy.tenants.items())
        },
    }, sort_keys=True)


def load_policy_file(path: str) -> QosPolicy:
    """Static-file fallback for registry-less deployments (the
    ``--qos-policy`` flag).  Missing/unreadable file → defaults, same
    degrade-don't-crash stance as the registry path."""
    try:
        with open(path, encoding="utf-8") as fh:
            return decode_policy(fh.read())
    except OSError:
        return DEFAULT_POLICY
