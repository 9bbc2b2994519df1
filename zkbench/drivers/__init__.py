"""Request drivers, one module per operation of the system; a traffic mix
(`traffic/<name>.json`) names its driver under "driver".

A module defines `Driver(config, traffic, seed, device)` with:

- `setup()`: the program's set-up and warm-up from the seed (timed as setup_s);
- `request(i)`: the i-th request of the closed loop; returns its answer on
  the host (the work has finished on the device when it returns);
- `work`: nominal work units of one request, for rates (None if unused);
- `release()`: drop the program's device state before the reference runs;
- `check(answers)`: ([(name, value, limit)], failed) from the plain reference;
- `control()` and `fault(name)`: context managers that put the reference at
  a lower precision in the program's place, or break the timed path (the
  checks of the check; the benchmark's own runs use neither).
"""
