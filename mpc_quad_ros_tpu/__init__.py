"""mpc_quad_ros_tpu — a batched quadrotor-MPC + online recursive-GP framework.

A from-scratch JAX/XLA re-design of the capabilities of the reference
system `smidmatej/mpc_quad_ros` (nonlinear MPC for a 13-state quadrotor with
online recursive-Gaussian-process drag learning).  Everything on the compute
path is a pure, jit/vmap/pjit-compatible function:

- ``utils``    : quaternion/rotation algebra, reference-chunk gathers, IO helpers
- ``models``   : quadrotor rigid-body dynamics (plant + MPC model), GP / RGP
- ``ops``      : the MPC engine — SQP-RTI linearization, condensed box-QP and
                 Riccati solvers, per scenario and batched
- ``traj``     : trajectory generation (analytic circles, min-snap polynomials —
                 native C++ optimizer, CSV-compatible with the reference)
- ``loop``     : closed-loop episodes as ``lax.scan``; scenario batching via vmap
- ``parallel`` : device-mesh sharding of scenario batches (shard_map + collectives)
- ``io``       : logging, config/CLI, visualisation parity
- ``bench``    : solves/s, latency, parity-vs-reference harnesses

The reference is CUDA/C++/CasADi/acados; this package is NOT a port — the
acados OCP solver is replaced by a batched Gauss-Newton SQP-RTI with a
condensed box-constrained QP solved by a fixed-iteration primal-dual interior
point method (vmappable; no data-dependent control flow), and the CasADi
symbolic model is replaced by JAX tracing + autodiff.
"""

__version__ = "0.1.0"
