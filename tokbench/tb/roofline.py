"""The yardstick of the kernels: the least time for the work, whatever
implements it.

The work of a call is its input's UTF-8 bytes read once and 4 B for each
output id written once.  Its least time is those bytes at the card's peak
memory bandwidth; ``kernel_roofline_pct`` is that over the kernels'
profiled device time.  The count does not depend on how the program splits,
dedups, fuses or moves its kernels, so no later change can move the
yardstick.  Peaks are the published ones at the full power limit (NVIDIA's
H100 data sheet); the run prints the card's power limit beside them."""

from __future__ import annotations

ID_BYTES = 4
# device name (torch.cuda.get_device_name) -> peak memory bandwidth, B/s
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}  # H100 SXM5


def least_seconds(bytes_in: int, ids_out: int, device_name: str
                  ) -> float | None:
    peak = PEAK_BYTES_PER_S.get(device_name)
    if peak is None:
        return None
    return (bytes_in + ID_BYTES * ids_out) / peak


def roofline_pct(bytes_in: int, ids_out: int, kernel_s: float,
                 device_name: str) -> float | None:
    least = least_seconds(bytes_in, ids_out, device_name)
    if least is None or not kernel_s > 0:
        return None
    return 100.0 * least / kernel_s
