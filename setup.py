from setuptools import setup, find_packages

setup(
    name="mfx",
    version="0.1.0",
    description="TPU-native matrix factorization training framework (JAX/Pallas)",
    packages=find_packages(include=["mfx", "mfx.*", "mfx_torch", "mfx_torch.*"]),
    package_data={"mfx_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
)
