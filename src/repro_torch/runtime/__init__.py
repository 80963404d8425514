"""Closed-loop photonic device runtime (PyTorch port).

Counterpart of ``repro/runtime``.  The IC → PM → SL pipeline prepares a
chip once; in production the chip lives under time, and thermal and
aging drift walk Γ / Φ_b away from the calibrated state.  This package
closes the loop, talking to devices only through the
:class:`~repro_torch.hw.PhotonicDriver` ABC:

    monitor.py      the sensor:   stochastic fidelity probes + hysteretic
                                  alarm, per tenant from one probe stream
    recalibrate.py  the actuator: warm ZO job + OSP refresh (+ in-situ Σ),
                                  scoped to one tenant's block range
    fleet.py        the plane:    N-chip registry + tenant slots + the
                                  drift-aware (chip, tenant) router
    autopilot.py    forecast-driven maintenance scheduling
    hw_serve.py     the served LM's PTC layers as tenants on the fleet
    demo.py         the driver:   ``python -m repro_torch.runtime.demo``

(the plant, OU phase drift on the device realization, lives device-side
in ``repro_torch.hw.drift``; the runtime sees it only through
``driver.advance`` and probe estimates).  Serving never blocks on
maintenance (RECALIBRATING chips are never dispatched to), repairs are
tenant-scoped, alarms are hysteretic, every draw is seeded, and every op
that touches light is metered by the driver.
"""

from .monitor import (MonitorConfig, HealthState, aggregate_distance,
                      probe_mapping_distance, probe_tenant_distances,
                      score_tenant_probes, readout_mapping_distance,
                      probe_identity_distance, update_health,
                      clear_health)
from .recalibrate import (RecalConfig, RecalResult, recalibrate,
                          autotune_zo_steps)
from .fleet import (HEALTHY, DEGRADED, RECALIBRATING, RuntimeConfig, Tenant,
                    Chip, FleetRouter, make_chip, make_fleet, make_router,
                    predicted_distance)
from .hw_serve import PTCLayerSpec, record_ptc_layers, HwServePlane

__all__ = ["MonitorConfig", "HealthState", "aggregate_distance",
           "probe_mapping_distance", "probe_tenant_distances",
           "score_tenant_probes", "readout_mapping_distance",
           "probe_identity_distance", "update_health", "clear_health",
           "RecalConfig", "RecalResult", "recalibrate", "autotune_zo_steps",
           "HEALTHY", "DEGRADED", "RECALIBRATING", "RuntimeConfig", "Tenant",
           "Chip", "FleetRouter", "make_chip", "make_fleet", "make_router",
           "predicted_distance", "PTCLayerSpec", "record_ptc_layers",
           "HwServePlane"]
