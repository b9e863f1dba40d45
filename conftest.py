# Directories that .gitignore lists may hold a second checkout of the
# repo (a parent commit unpacked to compare against on the card) or run
# outputs. Their test files share basenames with the ones in tests/ and
# portbench/, so collecting them would clash; pytest never looks there.
collect_ignore = ["chip_tree", "chiprun_out", "build"]
