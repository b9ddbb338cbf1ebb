#!/usr/bin/env bash
# Regenerate the CPU/f64 evidence logs cited in benchmarks/README.md
# (outputs/logs/*.log + outputs/convergence_tg_*/errors.csv).
# Serial by design: this box has one CPU core. The convergence studies use
# per-leg npz caching (--cache), so an interrupted run resumes where it left.
#
#   nohup bash benchmarks/regen_evidence_cpu.sh > /tmp/regen_cpu.log 2>&1 &
set -u
cd "$(dirname "$0")/.."
mkdir -p outputs/logs

stamp() { echo "=== [$(date '+%F %T')] $*"; }

run_py() { # run_py <logfile> <python heredoc body on stdin>
  local log="$1"
  stamp "-> $log"
  python - >"outputs/logs/$log" 2>&1
  stamp "done: $log (exit $?)"
}

# ---- 1. f64 convergence studies, full reference protocol -------------------
stamp "convergence f64, default stress (grids 32..256 vs N=512)"
python benchmarks/convergence_taylor_green.py semilagrangian \
  --cpu --f64 --full --cache > outputs/logs/conv_f64_default.log 2>&1
stamp "done: conv_f64_default.log (exit $?)"

stamp "convergence f64, stress_band (grids 32..256 vs N=512)"
python benchmarks/convergence_taylor_green.py semilagrangian \
  --cpu --f64 --full --cache --stress-band > outputs/logs/conv_f64_band.log 2>&1
stamp "done: conv_f64_band.log (exit $?)"

# ---- 2. f64 driver confirmations -------------------------------------------
run_py f64_confirms.log <<'EOF'
import sys; sys.argv += ["--cpu", "--f64"]
from benchmarks.common import apply_cli_platform; apply_cli_platform()
print("### surface_tension_drop N=64 gamma=0.1 R=0.25 f64")
import benchmarks.surface_tension_drop as st
st.run(N=64, gamma=0.1, R=0.25, dtype="float64")
print("### disc_in_taylor_green N=128 f64")
import benchmarks.disc_in_taylor_green as tg
tg.run(N=128, dtype="float64")
print("### two_disc_tg_collision N=128 t=2 f64")
import benchmarks.two_disc_tg_collision as col
col.run(N=128, t_end=2.0, dtype="float64")
print("### two_disc_contact N=64 t=1.5 V0=0.15 k_rep=2.0 f64")
import benchmarks.two_disc_contact as tc
tc.run(N=64, t_end=1.5, V0=0.15, k_rep=2.0, dtype="float64")
EOF

# ---- 3. Eulerian-scheme end-to-end behaviour (soft disc N=64 f64) -----------
run_py sd64_schemes.log <<'EOF'
import sys; sys.argv += ["--cpu", "--f64"]
from benchmarks.common import apply_cli_platform; apply_cli_platform()
import benchmarks.soft_disc_in_lid_driven as sd
for scheme in ("semilagrangian", "weno5", "central2"):
    print(f"### scheme={scheme} N=64 t_end=8 f64", flush=True)
    try:
        sd.run(N=64, scheme=scheme, t_end=8.0, dtype="float64")
    except Exception as e:  # graceful-divergence path prints its own report
        print(f"[driver raised] {type(e).__name__}: {e}")
EOF

# ---- 4. Band-mode stability rule (num_layers sweep, N=64 f64) ---------------
run_py softdisc_band_f64_diag.log <<'EOF'
import sys; sys.argv += ["--cpu", "--f64"]
from benchmarks.common import apply_cli_platform; apply_cli_platform()
import benchmarks.soft_disc_in_lid_driven as sd
print("### stress_band=True num_layers=3 (reference's own layer count) N=64 f64")
sd.run(N=64, t_end=8.0, dtype="float64", stress_band=True)
EOF

run_py band_layers_sweep.log <<'EOF'
import sys; sys.argv += ["--cpu", "--f64"]
from benchmarks.common import apply_cli_platform; apply_cli_platform()
import benchmarks.soft_disc_in_lid_driven as sd
for L in (4, 5, 6):
    print(f"### stress_band=True num_layers={L} N=64 t_end=8 f64", flush=True)
    sd.run(N=64, t_end=8.0, dtype="float64", stress_band=True,
           cfg_overrides={"num_layers": L})
EOF

# ---- 5. N=128 band-mode runs (diag L3 + validated L4) -----------------------
run_py softdisc_band_N128_diag.log <<'EOF'
import sys; sys.argv += ["--cpu", "--f64"]
from benchmarks.common import apply_cli_platform; apply_cli_platform()
import benchmarks.soft_disc_in_lid_driven as sd
print("### stress_band=True num_layers=3 N=128 f64 (expected: destabilises ~t=4)")
sd.run(N=128, t_end=8.0, dtype="float64", stress_band=True)
EOF

run_py band_N128_L4_driver.log <<'EOF'
import sys; sys.argv += ["--cpu", "--f64"]
from benchmarks.common import apply_cli_platform; apply_cli_platform()
import benchmarks.soft_disc_in_lid_driven as sd
print("### stress_band=True num_layers=4 N=128 f64 (validated band-mode run)")
sd.run(N=128, t_end=8.0, dtype="float64", stress_band=True,
       cfg_overrides={"num_layers": 4})
EOF

# ---- 6. Default-mode N=128 f64 headline (also the CPU-perf record) ----------
run_py sd128_f64.log <<'EOF'
import sys; sys.argv += ["--cpu", "--f64"]
from benchmarks.common import apply_cli_platform; apply_cli_platform()
import benchmarks.soft_disc_in_lid_driven as sd
print("### default config N=128 t_end=8 f64 (XLA path, single CPU core)")
sd.run(N=128, t_end=8.0, dtype="float64")
EOF

# ---- 7. N=1024-referenced extensions (reuse cached legs; adds N=1024 leg) ---
run_py conv_f64_ref1024.log <<'EOF'
import sys; sys.argv += ["--cpu", "--f64"]
from benchmarks.common import apply_cli_platform; apply_cli_platform()
from benchmarks.convergence_taylor_green import run
run(scheme="semilagrangian", grids=(32, 64, 128, 256, 512), N_ref=1024,
    dtype="float64", cache=True)
EOF

run_py conv_f64_band_ref1024.log <<'EOF'
import sys; sys.argv += ["--cpu", "--f64"]
from benchmarks.common import apply_cli_platform; apply_cli_platform()
from benchmarks.convergence_taylor_green import run
run(scheme="semilagrangian", grids=(32, 64, 128, 256, 512), N_ref=1024,
    dtype="float64", stress_band=True, cache=True)
EOF

# ---- 8b. Bicubic SL convergence (raw = the recorded pre-guard variant,
#          cache tag _bicubic_raw; guarded = the sl_interp='bicubic'
#          defaults, cache tag _bicubic) -------------------------------------
stamp "convergence f64, bicubic raw (grids 32..256 vs N=512)"
python benchmarks/convergence_taylor_green.py semilagrangian \
  --cpu --f64 --full --cache --bicubic-raw \
  > outputs/logs/conv_f64_bicubic.log 2>&1
stamp "done: conv_f64_bicubic.log (exit $?)"

stamp "convergence f64, bicubic band-guarded (grids 32..256 vs N=512)"
python benchmarks/convergence_taylor_green.py semilagrangian \
  --cpu --f64 --full --cache --bicubic \
  > outputs/logs/conv_f64_bicubic_guard.log 2>&1
stamp "done: conv_f64_bicubic_guard.log (exit $?)"

# ---- 8. Band-order insensitivity to the stability layer depth ---------------
run_py conv_f64_band_L4.log <<'EOF'
import sys; sys.argv += ["--cpu", "--f64"]
from benchmarks.common import apply_cli_platform; apply_cli_platform()
from benchmarks.convergence_taylor_green import run
run(scheme="semilagrangian", grids=(32, 64, 128, 256), N_ref=512,
    dtype="float64", stress_band=True, num_layers=4, cache=True)
EOF

# ---- 9. Round-3 additions: balanced CSF, density contrast, coupled drop ----
run_py st_drop_modes_f64.log <<'PYEOF'
import sys; sys.argv += ["--cpu", "--f64"]
from benchmarks.common import apply_cli_platform; apply_cli_platform()
import benchmarks.surface_tension_drop as st
print("### csf (reference parity) N=64 f64")
st.run(N=64, gamma=0.1, R=0.25, dtype="float64")
print("### balanced N=64 f64")
st.run(N=64, gamma=0.1, R=0.25, dtype="float64", st_method="balanced")
print("### balanced + kappa_interface N=64 f64")
st.run(N=64, gamma=0.1, R=0.25, dtype="float64", st_method="balanced",
       kappa_interface=True)
PYEOF

run_py density_contrast_N128_f64.log <<'PYEOF'
import sys; sys.argv += ["--cpu", "--f64"]
from benchmarks.common import apply_cli_platform; apply_cli_platform()
import benchmarks.density_contrast_disc as dc
dc.run(N=128, rho_ratio=10.0, dtype="float64")
PYEOF

run_py capillary_drop_N128_f64.log <<'PYEOF'
import sys; sys.argv += ["--cpu", "--f64"]
from benchmarks.common import apply_cli_platform; apply_cli_platform()
import benchmarks.capillary_drop_coupled as cd
for kw in (dict(st_method="balanced"), dict(st_method="balanced", kappa_interface=True),
           dict(st_method="csf")):
    print(f"### {kw} N=128 f64", flush=True)
    cd.run(N=128, dtype="float64", **kw)
PYEOF

# ---- 10. Upstream arbitration reruns (the reference's own code) -------------
stamp "upstream rerun: two-disc contact"
python benchmarks/upstream_rerun/run_contact.py 1.5 \
  > outputs/logs/contact_N64_upstream_rerun.log 2>&1
stamp "done: contact_N64_upstream_rerun.log (exit $?)"
stamp "upstream rerun: convergence default + band (hours)"
python benchmarks/upstream_rerun/run_convergence.py default \
  > outputs/logs/upstream_conv_default.log 2>&1
python benchmarks/upstream_rerun/run_convergence.py band \
  > outputs/logs/upstream_conv_band.log 2>&1
stamp "done: upstream_conv_{default,band}.log"

stamp "ALL DONE"
