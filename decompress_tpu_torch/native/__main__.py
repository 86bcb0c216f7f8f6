from . import build

print(build())
