"""A workload program of the tests' own, shared by the CPU parity tests
(``tests/program_points.py``) and the run kernel's tests under the mock
(``tests/engine_mock.py``): local work and modify durations that differ
between steps, a barrier step mid-program, and every address mode
(uniform, fixed, the Zipf stream at skew 0); two fixed addresses.  It is
registered only for the length of a test."""

OWN = "own_program"
OWN_FIELDS = dict(kind=(0, 0, 1, 0), pre_mult=(1, 0, 2, 0),
                  pre_add=(0, 3, 1, 0), addr_mode=(0, 1, 1, 2),
                  addr_arg=(0, 1, 0, 0), mod_mult=(1, 0, 0, 2),
                  mod_add=(0, 5, 1, 3))
OWN_MIN_ADDRS = 2
#: ``engine_mock``'s ``programs`` argument for it
OWN_PROGRAMS = {OWN: (OWN_FIELDS, OWN_MIN_ADDRS)}
