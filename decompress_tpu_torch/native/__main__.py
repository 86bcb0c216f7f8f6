from . import PLAN_SRC, build

print(build())
print(build(PLAN_SRC))
