"""Fleet observability: per-replica occupancy, per-tenant QoS counters,
pooled commit-latency percentiles — one summary dict and one Prometheus
exposition for the whole fleet, labeled per replica/tenant/lane, built on
the same primitives (and the shared renderer) as StreamMetrics and
ServeMetrics so dashboards treat all three uniformly.

Copy of ``torchkafka_tpu/fleet/metrics.py`` (jax-free), its imports re-rooted onto
``torchkafka_tpu_torch``.
"""

from __future__ import annotations

from torchkafka_tpu_torch.utils.metrics import (
    Gauge,
    LatencyHistogram,
    RateMeter,
    format_labels,
    merge_latency_summaries,
    render_exposition,
)


class FleetMetrics:
    """The metric set one ServingFleet maintains.

    Per-tenant and per-lane series are created lazily through the
    accessors (``tenant_admitted`` etc.) so the tenant population never
    needs declaring up front — exactly like Prometheus label children.
    """

    def __init__(self) -> None:
        self.completions = RateMeter()
        self.duplicates = RateMeter()  # completions for an already-served
        # (topic, partition, offset): the fleet-level redelivery observable
        # — nonzero after a replica death, exactly zero in a clean run
        self.backpressure_pauses = RateMeter()
        self.backpressure_resumes = RateMeter()
        self.replica_deaths = RateMeter()
        self.drains = RateMeter()  # replicas that completed a graceful drain
        self.journal_handoffs = RateMeter()  # journal entries handed from a
        # dead replica to survivors as warm-resume hints
        self.drain_timeout_kills = RateMeter()  # replicas killed for
        # overrunning the drain timeout (journal synced first, so the next
        # incarnation resumes warm)
        self.replica_joins = RateMeter()  # members that joined the group
        # (initial spawn, respawn after fencing, scale-up)
        self.replica_fences = RateMeter()  # members evicted involuntarily:
        # lease expiry (real process death or a zombie too slow to renew),
        # kill, or drain-timeout escalation
        self.broker_restarts = RateMeter()  # broker deaths recovered from
        # the write-ahead log (ProcessFleet.restart_broker)
        self.leader_elections = RateMeter()  # broker-cell failovers: a
        # leader death absorbed by an epoch-bumped election + follower
        # promotion (ProcessFleet.kill_leader or a lapsed leader lease)
        self._member_lease_age: dict[str, Gauge] = {}  # seconds since the
        # member's last successful lease renewal (age = session timeout
        # minus observed remaining; 0 right after a heartbeat)
        # Live model lifecycle (fleet/rollout.py): the controller's
        # current phase (0 pending / 1 canary / 2 rolling / 3 complete /
        # 4 rolled_back), each member's serving version, canary shadow
        # token diffs, automatic rollbacks by reason, and checkpoint
        # frames rejected by the wire's CRC/shape gates (graceful
        # degradation — the replica keeps serving the incumbent).
        self.rollout_phase = Gauge()
        self.rollout_target_version = Gauge()
        self.canary_token_diffs = RateMeter()
        self._replica_model_version: dict[str, Gauge] = {}
        self._rollbacks: dict[str, RateMeter] = {}
        self._ckpt_rejects: dict[str, RateMeter] = {}
        # Online draft distillation (torchkafka_tpu_torch/distill): the closed
        # loop's fleet-level view — the controller's windowed live-α,
        # the draft version it applied, each member's proposing draft,
        # refresh verdicts by reason, and the trainer's progress
        # (aggregated from trainer reports). All zero without a loop.
        self.spec_alpha_window = Gauge()
        self.draft_version = Gauge()  # fleet-APPLIED draft version
        self.distill_steps = RateMeter()
        self.distill_records = RateMeter()
        self._draft_refreshes: dict[str, RateMeter] = {}
        self._replica_draft_version: dict[str, Gauge] = {}
        # Autoscale controller families (fleet/autoscale.py): decision
        # counters labeled {role, direction, reason}, the controller's
        # current per-role target, and which phase (steady / scaling_up /
        # scaling_down) it sits in + for how long.
        self._autoscale_decisions: dict[tuple[str, str, str], RateMeter] = {}
        self._autoscale_target: dict[str, Gauge] = {}
        self._autoscale_phase: dict[str, Gauge] = {}
        self._autoscale_phase_s: dict[str, Gauge] = {}
        self._tenant_admitted: dict[str, RateMeter] = {}
        self._tenant_throttled: dict[str, RateMeter] = {}
        self._tenant_deferred: dict[str, RateMeter] = {}  # burn-rate
        # overload deferrals (AdmissionQueue's shedding hook) — distinct
        # from bucket throttles: policy chose to wait, not the tenant's rate
        self._tenant_queue_depth: dict[str, Gauge] = {}
        self._lane_wait: dict[str, LatencyHistogram] = {}
        self._replica_occupancy: dict[int, Gauge] = {}
        self._replica_completions: dict[int, RateMeter] = {}
        self._slo = None  # obs.SLOHistograms, attached by a traced fleet
        self._burn = None  # obs.BurnRateMonitor, attached alongside

    def attach_slo(self, slo) -> None:
        """Bind the fleet tracer's derived SLO histograms
        (``obs.SLOHistograms``) so TTFT / inter-token latency / queue
        wait / e2e percentiles per lane+tenant+replica ride this class's
        ``summary()`` and Prometheus exposition alongside the counters."""
        self._slo = slo

    def attach_burn(self, monitor) -> None:
        """Bind the fleet's ``obs.BurnRateMonitor`` so burn-rate states
        and the per-tenant goodput ledger (completed / within-SLO /
        deferred / quarantined) ride ``summary()`` and the exposition."""
        self._burn = monitor

    # ------------------------------------------------------ lazy accessors

    def tenant_admitted(self, tenant: str) -> RateMeter:
        return self._tenant_admitted.setdefault(tenant, RateMeter())

    def tenant_throttled(self, tenant: str) -> RateMeter:
        return self._tenant_throttled.setdefault(tenant, RateMeter())

    def tenant_deferred(self, tenant: str) -> RateMeter:
        return self._tenant_deferred.setdefault(tenant, RateMeter())

    def tenant_queue_depth(self, tenant: str) -> Gauge:
        return self._tenant_queue_depth.setdefault(tenant, Gauge())

    def lane_wait(self, lane: str) -> LatencyHistogram:
        return self._lane_wait.setdefault(lane, LatencyHistogram())

    def replica_occupancy(self, rid: int) -> Gauge:
        return self._replica_occupancy.setdefault(rid, Gauge())

    def replica_completions(self, rid: int) -> RateMeter:
        return self._replica_completions.setdefault(rid, RateMeter())

    def member_lease_age(self, member: str) -> Gauge:
        return self._member_lease_age.setdefault(member, Gauge())

    def autoscale_decision(self, role: str, direction: str,
                           reason: str) -> RateMeter:
        return self._autoscale_decisions.setdefault(
            (role, direction, reason), RateMeter()
        )

    def autoscale_target(self, role: str) -> Gauge:
        return self._autoscale_target.setdefault(role, Gauge())

    def autoscale_phase(self, role: str) -> Gauge:
        return self._autoscale_phase.setdefault(role, Gauge())

    def autoscale_time_in_phase(self, role: str) -> Gauge:
        return self._autoscale_phase_s.setdefault(role, Gauge())

    def replica_model_version(self, member: str) -> Gauge:
        return self._replica_model_version.setdefault(member, Gauge())

    def rollback(self, reason: str) -> RateMeter:
        return self._rollbacks.setdefault(reason, RateMeter())

    def draft_refreshes(self, reason: str) -> RateMeter:
        return self._draft_refreshes.setdefault(reason, RateMeter())

    def replica_draft_version(self, member: str) -> Gauge:
        return self._replica_draft_version.setdefault(member, Gauge())

    def checkpoint_reject(self, reason: str) -> RateMeter:
        return self._ckpt_rejects.setdefault(reason, RateMeter())

    # ----------------------------------------------------------- reporting

    def summary(self, replicas=None) -> dict:
        """``replicas``: the fleet's replica list, for the pooled
        commit-latency percentiles (each replica's generator keeps its own
        histogram; the fleet view pools the sample windows) and the
        aggregated prefix-cache view (each replica owns a PER-REPLICA
        paged pool + radix tree — kvcache/ — so the fleet hit rate is the
        count-weighted merge of the per-replica counters)."""
        commit = merge_latency_summaries(
            [r.gen.metrics.commit_latency for r in replicas]
            if replicas else []
        )
        gens = [r.gen.metrics for r in replicas] if replicas else []
        hits = sum(m.prefix_hits.count for m in gens)
        misses = sum(m.prefix_misses.count for m in gens)
        occ = [m.cache_pool_occupancy.value for m in gens]
        cache = {
            "hits": hits,
            "misses": misses,
            "hit_rate": (
                round(hits / (hits + misses), 4) if hits + misses else None
            ),
            "prefix_tokens_saved": sum(
                m.prefix_tokens_saved.count for m in gens
            ),
            "prefill_tokens": sum(m.prefill_tokens.count for m in gens),
            "evictions": sum(m.cache_evictions.count for m in gens),
            "deferrals": sum(m.admission_deferrals.count for m in gens),
            "fallbacks": sum(m.cache_fallbacks.count for m in gens),
            "pool_occupancy": round(sum(occ) / len(occ), 3) if occ else 0.0,
            "tier": {
                "demotions": sum(m.radix_demotions.count for m in gens),
                "promotions": sum(m.radix_promotions.count for m in gens),
                "hits": sum(m.tier_hits.count for m in gens),
                "occupancy_bytes": int(sum(
                    m.tier_occupancy_bytes.value for m in gens
                )),
            },
        }
        disagg = {
            "prefill_routed": sum(m.prefill_routed.count for m in gens),
            "adopted_slots": sum(m.adopted_slots.count for m in gens),
            "handoffs_published": sum(
                m.handoffs_published.count for m in gens
            ),
        }
        chunk_ticks = sum(m.chunk_ticks.count for m in gens)
        chunk_prefill_tokens = sum(m.prefill_tokens.count for m in gens)
        chunked = {
            "chunk_ticks": chunk_ticks,
            "prefill_tokens_per_tick": (
                round(chunk_prefill_tokens / chunk_ticks, 2)
                if chunk_ticks else None
            ),
            "stall_ticks": sum(
                m.admission_stall_ticks.count for m in gens
            ),
            "queue_tokens": int(sum(
                m.admission_queue_tokens.value for m in gens
            )),
        }
        journal = {
            "handoffs": self.journal_handoffs.count,
            "drain_timeout_kills": self.drain_timeout_kills.count,
            "warm_resumes": sum(m.warm_resumes.count for m in gens),
            "tokens_restored": sum(
                m.journal_tokens_restored.count for m in gens
            ),
            "served_from_journal": sum(m.journal_served.count for m in gens),
            "resume_rejected": sum(m.resume_rejected.count for m in gens),
        }
        # Device-side "where did the tick go": per-replica step times
        # pooled with the same sample-window merge as the commit
        # percentiles, tokens-per-tick averaged over replicas that ticked.
        tpt = [
            m.tokens_per_tick.value for m in gens if m.tick_time.count
        ]
        serving = {
            "ticks": sum(m.tick_time.count for m in gens),
            "step_time": merge_latency_summaries(
                [m.tick_time for m in gens]
            ),
            "tokens_per_tick": (
                round(sum(tpt) / len(tpt), 2) if tpt else 0.0
            ),
            "output_capped": sum(m.output_capped.count for m in gens),
        }
        autoscale = {
            "targets": {
                role: int(g.value)
                for role, g in sorted(self._autoscale_target.items())
            },
            "phase": {
                role: int(g.value)
                for role, g in sorted(self._autoscale_phase.items())
            },
            "time_in_phase_s": {
                role: round(g.value, 4)
                for role, g in sorted(self._autoscale_phase_s.items())
            },
            "decisions": {
                f"{role}/{direction}/{reason}": m.count
                for (role, direction, reason), m in sorted(
                    self._autoscale_decisions.items()
                )
            },
        }
        rollout = {
            "phase": int(self.rollout_phase.value),
            "target_version": int(self.rollout_target_version.value),
            "canary_token_diffs": self.canary_token_diffs.count,
            "member_versions": {
                m: int(g.value)
                for m, g in sorted(self._replica_model_version.items())
            },
            "rollbacks": {
                reason: m.count
                for reason, m in sorted(self._rollbacks.items())
            },
            "checkpoint_rejects": {
                reason: m.count
                for reason, m in sorted(self._ckpt_rejects.items())
            },
        }
        distill = {
            "alpha_window": round(self.spec_alpha_window.value, 4),
            "applied_version": int(self.draft_version.value),
            "steps": self.distill_steps.count,
            "records": self.distill_records.count,
            "member_draft_versions": {
                m: int(g.value)
                for m, g in sorted(self._replica_draft_version.items())
            },
            "refreshes": {
                reason: m.count
                for reason, m in sorted(self._draft_refreshes.items())
            },
        }
        membership = {
            "joins": self.replica_joins.count,
            "fences": self.replica_fences.count,
            "broker_restarts": self.broker_restarts.count,
            "leader_elections": self.leader_elections.count,
            "lease_age_s": {
                m: round(g.value, 3)
                for m, g in sorted(self._member_lease_age.items())
            },
        }
        return {
            "membership": membership,
            "rollout": rollout,
            "distill": distill,
            "autoscale": autoscale,
            "slo": self._slo.summary() if self._slo is not None else None,
            "burn": (
                self._burn.summary() if self._burn is not None else None
            ),
            "goodput": (
                self._burn.goodput_summary()
                if self._burn is not None else None
            ),
            "serving": serving,
            "prefix_cache": cache,
            "disagg": disagg,
            "chunked_prefill": chunked,
            "journal": journal,
            "completions": self.completions.count,
            "completions_per_s": round(self.completions.rate(), 1),
            "duplicates": self.duplicates.count,
            "backpressure_pauses": self.backpressure_pauses.count,
            "backpressure_resumes": self.backpressure_resumes.count,
            "replica_deaths": self.replica_deaths.count,
            "drains": self.drains.count,
            "tenants": {
                t: {
                    "admitted": self.tenant_admitted(t).count,
                    "admitted_per_s": round(self.tenant_admitted(t).rate(), 2),
                    "throttled": self.tenant_throttled(t).count,
                    "deferred": self.tenant_deferred(t).count,
                    "queue_depth": int(self.tenant_queue_depth(t).value),
                }
                for t in sorted(
                    set(self._tenant_admitted)
                    | set(self._tenant_throttled)
                    | set(self._tenant_deferred)
                )
            },
            "lanes": {
                lane: h.summary() for lane, h in sorted(self._lane_wait.items())
            },
            "replicas": {
                rid: {
                    "slot_occupancy": round(
                        self.replica_occupancy(rid).value, 3
                    ),
                    "completions": self.replica_completions(rid).count,
                }
                for rid in sorted(self._replica_occupancy)
            },
            "commit": commit,
        }

    def render_prometheus(
        self, prefix: str = "torchkafka_fleet", replicas=None,
    ) -> str:
        s = self.summary(replicas)
        pc = s["prefix_cache"]
        cp = s["chunked_prefill"]
        sv = s["serving"]
        series = [
            ("serve_ticks_total", "counter", sv["ticks"]),
            ("step_time_ms", "gauge", [
                ('percentile="p50"', sv["step_time"]["p50_ms"]),
                ('percentile="p99"', sv["step_time"]["p99_ms"]),
            ]),
            ("tokens_per_tick", "gauge", sv["tokens_per_tick"]),
            ("output_capped_total", "counter", sv["output_capped"]),
            ("chunk_ticks_total", "counter", cp["chunk_ticks"]),
            ("admission_stall_ticks_total", "counter", cp["stall_ticks"]),
            ("admission_queue_tokens", "gauge", cp["queue_tokens"]),
            ("prefill_tokens_per_chunk_tick", "gauge",
             cp["prefill_tokens_per_tick"] or 0.0),
            ("completions_total", "counter", s["completions"]),
            ("duplicate_completions_total", "counter", s["duplicates"]),
            ("backpressure_pauses_total", "counter", s["backpressure_pauses"]),
            ("backpressure_resumes_total", "counter", s["backpressure_resumes"]),
            ("replica_deaths_total", "counter", s["replica_deaths"]),
            ("replica_drains_total", "counter", s["drains"]),
            ("replica_joins_total", "counter", s["membership"]["joins"]),
            ("replica_fences_total", "counter", s["membership"]["fences"]),
            ("broker_restarts_total", "counter",
             s["membership"]["broker_restarts"]),
            ("leader_elections_total", "counter",
             s["membership"]["leader_elections"]),
            ("member_lease_age_seconds", "gauge", [
                (format_labels(member=m), age)
                for m, age in s["membership"]["lease_age_s"].items()
            ] or 0),
            ("autoscale_decisions_total", "counter", [
                (
                    format_labels(
                        role=role, direction=direction, reason=reason
                    ),
                    m.count,
                )
                for (role, direction, reason), m in sorted(
                    self._autoscale_decisions.items()
                )
            ] or 0),
            ("autoscale_target_replicas", "gauge", [
                (format_labels(role=role), v)
                for role, v in s["autoscale"]["targets"].items()
            ] or 0),
            ("autoscale_phase", "gauge", [
                (format_labels(role=role), v)
                for role, v in s["autoscale"]["phase"].items()
            ] or 0),
            ("autoscale_time_in_phase_seconds", "gauge", [
                (format_labels(role=role), v)
                for role, v in s["autoscale"]["time_in_phase_s"].items()
            ] or 0),
            ("rollout_phase", "gauge", s["rollout"]["phase"]),
            ("rollout_target_version", "gauge",
             s["rollout"]["target_version"]),
            ("canary_token_diffs_total", "counter",
             s["rollout"]["canary_token_diffs"]),
            ("replica_model_version", "gauge", [
                (format_labels(member=m), v)
                for m, v in s["rollout"]["member_versions"].items()
            ] or 0),
            ("rollbacks_total", "counter", [
                (format_labels(reason=reason), v)
                for reason, v in s["rollout"]["rollbacks"].items()
            ] or 0),
            ("checkpoint_rejects_total", "counter", [
                (format_labels(reason=reason), v)
                for reason, v in s["rollout"]["checkpoint_rejects"].items()
            ] or 0),
            ("spec_alpha_window", "gauge", s["distill"]["alpha_window"]),
            ("draft_applied_version", "gauge",
             s["distill"]["applied_version"]),
            ("draft_version", "gauge", [
                (format_labels(member=m), v)
                for m, v in s["distill"]["member_draft_versions"].items()
            ] or 0),
            ("draft_refreshes_total", "counter", [
                (format_labels(reason=reason), v)
                for reason, v in s["distill"]["refreshes"].items()
            ] or 0),
            ("distill_steps_total", "counter", s["distill"]["steps"]),
            ("distill_records_total", "counter", s["distill"]["records"]),
            ("journal_handoffs_total", "counter", s["journal"]["handoffs"]),
            ("drain_timeout_kills_total", "counter",
             s["journal"]["drain_timeout_kills"]),
            ("warm_resumes_total", "counter", s["journal"]["warm_resumes"]),
            ("journal_tokens_restored_total", "counter",
             s["journal"]["tokens_restored"]),
            ("journal_served_total", "counter",
             s["journal"]["served_from_journal"]),
            ("resume_rejected_total", "counter",
             s["journal"]["resume_rejected"]),
            ("completions_per_second", "gauge", s["completions_per_s"]),
            ("tenant_admitted_total", "counter", [
                (format_labels(tenant=t), v["admitted"])
                for t, v in s["tenants"].items()
            ] or 0),
            ("tenant_throttled_total", "counter", [
                (format_labels(tenant=t), v["throttled"])
                for t, v in s["tenants"].items()
            ] or 0),
            ("tenant_deferred_total", "counter", [
                (format_labels(tenant=t), v["deferred"])
                for t, v in s["tenants"].items()
            ] or 0),
            ("tenant_queue_depth", "gauge", [
                (format_labels(tenant=t), v["queue_depth"])
                for t, v in s["tenants"].items()
            ] or 0),
            ("lane_queue_wait_ms", "gauge", [
                (format_labels(lane=lane, percentile="p50"), v["p50_ms"])
                for lane, v in s["lanes"].items()
            ] + [
                (format_labels(lane=lane, percentile="p99"), v["p99_ms"])
                for lane, v in s["lanes"].items()
            ] or 0),
            ("replica_slot_occupancy", "gauge", [
                (format_labels(replica=rid), v["slot_occupancy"])
                for rid, v in s["replicas"].items()
            ] or 0),
            ("replica_completions_total", "counter", [
                (format_labels(replica=rid), v["completions"])
                for rid, v in s["replicas"].items()
            ] or 0),
            ("commit_latency_ms", "gauge", [
                ('percentile="p50"', s["commit"]["p50_ms"]),
                ('percentile="p99"', s["commit"]["p99_ms"]),
            ]),
            ("prefix_cache_hits_total", "counter", pc["hits"]),
            ("prefix_cache_misses_total", "counter", pc["misses"]),
            ("prefix_tokens_saved_total", "counter", pc["prefix_tokens_saved"]),
            ("prefill_tokens_total", "counter", pc["prefill_tokens"]),
            ("kvcache_evictions_total", "counter", pc["evictions"]),
            ("admission_deferrals_total", "counter", pc["deferrals"]),
            ("prefix_cache_hit_rate", "gauge", pc["hit_rate"] or 0.0),
            ("kvcache_pool_occupancy", "gauge", pc["pool_occupancy"]),
            ("radix_demotions_total", "counter", pc["tier"]["demotions"]),
            ("radix_promotions_total", "counter", pc["tier"]["promotions"]),
            ("tier_hits_total", "counter", pc["tier"]["hits"]),
            ("tier_occupancy_bytes", "gauge", pc["tier"]["occupancy_bytes"]),
            ("prefill_routed_total", "counter",
             s["disagg"]["prefill_routed"]),
            ("adopted_slots_total", "counter", s["disagg"]["adopted_slots"]),
            ("prefill_handoffs_published_total", "counter",
             s["disagg"]["handoffs_published"]),
        ]
        if self._slo is not None:
            series.extend(self._slo.series())
        if self._burn is not None:
            series.extend(
                (f"burn_{name}", *rest)
                for name, *rest in self._burn.series()
            )
        return render_exposition(prefix, series)
