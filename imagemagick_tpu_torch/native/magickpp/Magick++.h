// Magick++ compatibility layer for imagemagick_tpu_torch, the PyTorch port.
//
// A C++ object API mirroring the reference Magick++ surface
// (Magick++/lib/Magick++/Image.h, Geometry.h, Color.h, Blob.h,
// Exception.h, Functions.h) backed by the port: the implementation embeds
// a CPython interpreter and dispatches every image method onto
// imagemagick_tpu_torch.wand.api.MagickWand, so C++ programs run the same
// torch ops and CUDA kernels as the Python/CLI layers.
//
// Value classes (Geometry, Color, Blob) are pure C++ — no interpreter
// needed to construct them.  Image methods require InitializeMagick()
// first, matching the reference contract (Magick++/lib/Functions.cpp).
//
// The device.  InitializeMagick(path, device) puts every image the
// library makes on `device`, a torch device string.  It defaults to
// MAGICKPP_DEVICE, "cuda" unless the program is compiled with
// -DMAGICKPP_DEVICE='"cpu"'.  Without a card, InitializeMagick for "cuda"
// throws Magick::Error with torch's CUDA error; nothing falls back to the
// CPU.
//
// Usage:
//   #include <Magick++.h>
//   int main(int argc, char** argv) {
//     Magick::InitializeMagick(*argv);          // on the card
//     Magick::Image img("input.png");
//     img.resize(Magick::Geometry("256x256"));
//     img.gaussianBlur(0.0, 2.0);
//     img.write("output.png");
//   }

#ifndef MAGICKPP_TORCH_H
#define MAGICKPP_TORCH_H

#include <cstddef>
#include <exception>
#include <string>
#include <vector>

#include "Drawable.h"

#ifndef MAGICKPP_DEVICE
#define MAGICKPP_DEVICE "cuda"
#endif

#if defined(_WIN32)
typedef long long magickpp_ssize_t;
#else
#include <sys/types.h>
typedef ssize_t magickpp_ssize_t;
#endif

namespace Magick {

// Pixels are float32 in [0,1] on the device (HDRI); the Quantum facade keeps
// the reference's 16-bit-depth numeric convention (MagickCore/magick-type.h).
typedef float Quantum;
static const double QuantumRange = 65535.0;

// ---------------------------------------------------------------------------
// Enumerations (MagickCore/*.h names; values are internal — do not rely on
// binary compatibility with the reference, only source compatibility).
// ---------------------------------------------------------------------------

enum FilterType {
  UndefinedFilter, PointFilter, BoxFilter, TriangleFilter, HermiteFilter,
  HannFilter, HammingFilter, BlackmanFilter, GaussianFilter, QuadraticFilter,
  CubicFilter, CatromFilter, MitchellFilter, JincFilter, SincFilter,
  SincFastFilter, KaiserFilter, WelchFilter, ParzenFilter, BohmanFilter,
  BartlettFilter, LagrangeFilter, LanczosFilter, LanczosSharpFilter,
  Lanczos2Filter, Lanczos2SharpFilter, RobidouxFilter, RobidouxSharpFilter,
  CosineFilter, SplineFilter
};

enum CompositeOperator {
  UndefinedCompositeOp, AlphaCompositeOp, AtopCompositeOp, BlendCompositeOp,
  BlurCompositeOp, BumpmapCompositeOp, ChangeMaskCompositeOp,
  ClearCompositeOp, ColorBurnCompositeOp, ColorDodgeCompositeOp,
  ColorizeCompositeOp, CopyBlackCompositeOp, CopyBlueCompositeOp,
  CopyCompositeOp, CopyCyanCompositeOp, CopyGreenCompositeOp,
  CopyMagentaCompositeOp, CopyAlphaCompositeOp, CopyRedCompositeOp,
  CopyYellowCompositeOp, DarkenCompositeOp, DarkenIntensityCompositeOp,
  DifferenceCompositeOp, DisplaceCompositeOp, DissolveCompositeOp,
  DistortCompositeOp, DivideDstCompositeOp, DivideSrcCompositeOp,
  DstAtopCompositeOp, DstCompositeOp, DstInCompositeOp, DstOutCompositeOp,
  DstOverCompositeOp, ExclusionCompositeOp, HardLightCompositeOp,
  HardMixCompositeOp, HueCompositeOp, InCompositeOp, IntensityCompositeOp,
  LightenCompositeOp, LightenIntensityCompositeOp, LinearBurnCompositeOp,
  LinearDodgeCompositeOp, LinearLightCompositeOp, LuminizeCompositeOp,
  MathematicsCompositeOp, MinusDstCompositeOp, MinusSrcCompositeOp,
  ModulateCompositeOp, ModulusAddCompositeOp, ModulusSubtractCompositeOp,
  MultiplyCompositeOp, NoCompositeOp, OutCompositeOp, OverCompositeOp,
  OverlayCompositeOp, PegtopLightCompositeOp, PinLightCompositeOp,
  PlusCompositeOp, ReplaceCompositeOp, SaturateCompositeOp,
  ScreenCompositeOp, SoftLightCompositeOp, SrcAtopCompositeOp,
  SrcCompositeOp, SrcInCompositeOp, SrcOutCompositeOp, SrcOverCompositeOp,
  ThresholdCompositeOp, VividLightCompositeOp, XorCompositeOp
};

enum ColorspaceType {
  UndefinedColorspace, CMYColorspace, CMYKColorspace, GRAYColorspace,
  HCLColorspace, HSBColorspace, HSLColorspace, HSVColorspace, HWBColorspace,
  LabColorspace, LCHColorspace, LinearGRAYColorspace, LogColorspace,
  LuvColorspace, OHTAColorspace, Rec601YCbCrColorspace,
  Rec709YCbCrColorspace, RGBColorspace, scRGBColorspace, sRGBColorspace,
  TransparentColorspace, XYZColorspace, YCbCrColorspace, YCCColorspace,
  YIQColorspace, YPbPrColorspace, YUVColorspace
};

enum GravityType {
  UndefinedGravity, ForgetGravity, NorthWestGravity, NorthGravity,
  NorthEastGravity, WestGravity, CenterGravity, EastGravity,
  SouthWestGravity, SouthGravity, SouthEastGravity
};

enum NoiseType {
  UndefinedNoise, UniformNoise, GaussianNoise, MultiplicativeGaussianNoise,
  ImpulseNoise, LaplacianNoise, PoissonNoise, RandomNoise
};

enum MetricType {
  UndefinedErrorMetric, AbsoluteErrorMetric, FuzzErrorMetric,
  MeanAbsoluteErrorMetric, MeanErrorPerPixelErrorMetric,
  MeanSquaredErrorMetric, NormalizedCrossCorrelationErrorMetric,
  PeakAbsoluteErrorMetric, PeakSignalToNoiseRatioErrorMetric,
  PerceptualHashErrorMetric, RootMeanSquaredErrorMetric,
  StructuralSimilarityErrorMetric, StructuralDissimilarityErrorMetric
};

enum DistortMethod {
  UndefinedDistortion, AffineDistortion, AffineProjectionDistortion,
  ScaleRotateTranslateDistortion, PerspectiveDistortion,
  PerspectiveProjectionDistortion, BilinearForwardDistortion,
  BilinearReverseDistortion, PolynomialDistortion, ArcDistortion,
  PolarDistortion, DePolarDistortion, Cylinder2PlaneDistortion,
  Plane2CylinderDistortion, BarrelDistortion, BarrelInverseDistortion,
  ShepardsDistortion
};

enum AlphaChannelOption {
  UndefinedAlphaChannel, ActivateAlphaChannel, AssociateAlphaChannel,
  BackgroundAlphaChannel, CopyAlphaChannel, DeactivateAlphaChannel,
  DiscreteAlphaChannel, DisassociateAlphaChannel, ExtractAlphaChannel,
  OffAlphaChannel, OnAlphaChannel, OpaqueAlphaChannel, RemoveAlphaChannel,
  SetAlphaChannel, ShapeAlphaChannel, TransparentAlphaChannel
};

enum ChannelType {
  UndefinedChannel, RedChannel, GreenChannel, BlueChannel, AlphaChannel,
  GrayChannel, CyanChannel, MagentaChannel, YellowChannel, BlackChannel,
  AllChannels
};

enum OrientationType {
  UndefinedOrientation, TopLeftOrientation, TopRightOrientation,
  BottomRightOrientation, BottomLeftOrientation, LeftTopOrientation,
  RightTopOrientation, RightBottomOrientation, LeftBottomOrientation
};

enum MorphologyMethod {
  UndefinedMorphology, ConvolveMorphology, CorrelateMorphology,
  ErodeMorphology, DilateMorphology, ErodeIntensityMorphology,
  DilateIntensityMorphology, OpenMorphology, CloseMorphology,
  OpenIntensityMorphology, CloseIntensityMorphology, SmoothMorphology,
  EdgeInMorphology, EdgeOutMorphology, EdgeMorphology, TopHatMorphology,
  BottomHatMorphology, HitAndMissMorphology, ThinningMorphology,
  ThickenMorphology, DistanceMorphology, IterativeDistanceMorphology
};

enum AutoThresholdMethod {
  UndefinedThresholdMethod, KapurThresholdMethod, OTSUThresholdMethod,
  TriangleThresholdMethod
};

enum StorageType {
  UndefinedPixel, CharPixel, DoublePixel, FloatPixel, LongPixel,
  ShortPixel
};

enum ImageType {
  UndefinedType, BilevelType, GrayscaleType, GrayscaleAlphaType,
  PaletteType, PaletteAlphaType, TrueColorType, TrueColorAlphaType,
  ColorSeparationType, ColorSeparationAlphaType, OptimizeType,
  PaletteBilevelAlphaType
};

enum EvaluateOperator {
  UndefinedEvaluateOperator, AbsEvaluateOperator, AddEvaluateOperator,
  AddModulusEvaluateOperator, AndEvaluateOperator, CosineEvaluateOperator,
  DivideEvaluateOperator, ExponentialEvaluateOperator,
  GaussianNoiseEvaluateOperator, LeftShiftEvaluateOperator,
  LogEvaluateOperator, MaxEvaluateOperator, MeanEvaluateOperator,
  MedianEvaluateOperator, MinEvaluateOperator, MultiplyEvaluateOperator,
  OrEvaluateOperator, PowEvaluateOperator, RightShiftEvaluateOperator,
  RootMeanSquareEvaluateOperator, SetEvaluateOperator, SineEvaluateOperator,
  SubtractEvaluateOperator, ThresholdEvaluateOperator,
  ThresholdBlackEvaluateOperator, ThresholdWhiteEvaluateOperator,
  UniformNoiseEvaluateOperator, XorEvaluateOperator
};

enum ClassType { UndefinedClass, DirectClass, PseudoClass };

enum CompressionType {
  UndefinedCompression, B44ACompression, B44Compression, BZipCompression,
  DXT1Compression, DXT3Compression, DXT5Compression, FaxCompression,
  Group4Compression, JBIG1Compression, JBIG2Compression,
  JPEG2000Compression, JPEGCompression, LosslessJPEGCompression,
  LZMACompression, LZWCompression, NoCompression, PizCompression,
  Pxr24Compression, RLECompression, ZipCompression, ZipSCompression,
  ZstdCompression, WebPCompression, DWAACompression, DWABCompression
};

enum EndianType { UndefinedEndian, LSBEndian, MSBEndian };

enum FillRule { UndefinedRule, EvenOddRule, NonZeroRule };

enum StyleType {
  UndefinedStyle, NormalStyle, ItalicStyle, ObliqueStyle, AnyStyle,
  BoldStyle
};

enum DisposeType {
  UnrecognizedDispose, UndefinedDispose = 0, NoneDispose = 1,
  BackgroundDispose = 2, PreviousDispose = 3
};

enum PixelChannel {
  UndefinedPixelChannel = 0, RedPixelChannel = 0, CyanPixelChannel = 0,
  GrayPixelChannel = 0, LPixelChannel = 0, YPixelChannel = 0,
  aPixelChannel = 1, GreenPixelChannel = 1, MagentaPixelChannel = 1,
  CbPixelChannel = 1, bPixelChannel = 2, BluePixelChannel = 2,
  YellowPixelChannel = 2, CrPixelChannel = 2, BlackPixelChannel = 3,
  AlphaPixelChannel = 4, IndexPixelChannel = 5, CompositePixelChannel = 64
};

enum InterlaceType {
  UndefinedInterlace, NoInterlace, LineInterlace, PlaneInterlace,
  PartitionInterlace, GIFInterlace, JPEGInterlace, PNGInterlace
};

enum PixelInterpolateMethod {
  UndefinedInterpolatePixel, AverageInterpolatePixel,
  Average9InterpolatePixel, Average16InterpolatePixel,
  BackgroundInterpolatePixel, BilinearInterpolatePixel,
  BlendInterpolatePixel, CatromInterpolatePixel, IntegerInterpolatePixel,
  MeshInterpolatePixel, NearestInterpolatePixel, SplineInterpolatePixel
};

enum DitherMethod {
  UndefinedDitherMethod, NoDitherMethod, RiemersmaDitherMethod,
  FloydSteinbergDitherMethod
};

enum RenderingIntent {
  UndefinedIntent, SaturationIntent, PerceptualIntent, AbsoluteIntent,
  RelativeIntent
};

enum LineCap { UndefinedCap, ButtCap, RoundCap, SquareCap };
enum LineJoin { UndefinedJoin, MiterJoin, RoundJoin, BevelJoin };

enum DirectionType {
  UndefinedDirection, RightToLeftDirection, LeftToRightDirection,
  TopToBottomDirection
};

enum VirtualPixelMethod {
  UndefinedVirtualPixelMethod, BackgroundVirtualPixelMethod,
  DitherVirtualPixelMethod, EdgeVirtualPixelMethod,
  MirrorVirtualPixelMethod, RandomVirtualPixelMethod,
  TileVirtualPixelMethod, TransparentVirtualPixelMethod,
  MaskVirtualPixelMethod, BlackVirtualPixelMethod, GrayVirtualPixelMethod,
  WhiteVirtualPixelMethod, HorizontalTileVirtualPixelMethod,
  VerticalTileVirtualPixelMethod, HorizontalTileEdgeVirtualPixelMethod,
  VerticalTileEdgeVirtualPixelMethod, CheckerTileVirtualPixelMethod
};

enum KernelInfoType {
  UndefinedKernel, UnityKernel, GaussianKernel, DoGKernel, LoGKernel,
  BlurKernel, CometKernel, BinomialKernel, LaplacianKernel, SobelKernel,
  FreiChenKernel, RobertsKernel, PrewittKernel, CompassKernel,
  KirschKernel, DiamondKernel, SquareKernel, RectangleKernel,
  OctagonKernel, DiskKernel, PlusKernel, CrossKernel, RingKernel,
  PeaksKernel, EdgesKernel, CornersKernel, DiagonalsKernel,
  LineEndsKernel, LineJunctionsKernel, RidgesKernel, ConvexHullKernel,
  ThinSEKernel, SkeletonKernel, ChebyshevKernel, ManhattanKernel,
  OctagonalKernel, EuclideanKernel, UserDefinedKernel
};

enum SparseColorMethod {
  UndefinedColorInterpolate, BarycentricColorInterpolate,
  BilinearColorInterpolate, PolynomialColorInterpolate,
  ShepardsColorInterpolate, VoronoiColorInterpolate,
  InverseColorInterpolate, ManhattanColorInterpolate
};

enum PixelMask {
  UndefinedPixelMask = 0, ReadPixelMask = 1, WritePixelMask = 2,
  CompositePixelMask = 4
};

// ---------------------------------------------------------------------------
// Small value classes (Magick++/lib/Magick++/Point.h, TypeMetric.h,
// Statistic.h)
// ---------------------------------------------------------------------------

class Point {
 public:
  Point() : x_(0), y_(0) {}
  Point(double x, double y) : x_(x), y_(y) {}
  explicit Point(double xy) : x_(xy), y_(xy) {}
  explicit Point(const std::string& s);
  double x() const { return x_; }
  double y() const { return y_; }
  bool isValid() const { return x_ > 0.0; }

 private:
  double x_, y_;
};

class Offset {
 public:
  Offset(magickpp_ssize_t x, magickpp_ssize_t y) : x_(x), y_(y) {}
  explicit Offset(const std::string& s);
  magickpp_ssize_t x() const { return x_; }
  magickpp_ssize_t y() const { return y_; }

 private:
  magickpp_ssize_t x_, y_;
};

class TypeMetric {
 public:
  TypeMetric()
      : ascent_(0), descent_(0), textWidth_(0), textHeight_(0),
        maxHorizontalAdvance_(0), underlinePosition_(0),
        underlineThickness_(0) {}
  double ascent() const { return ascent_; }
  double descent() const { return descent_; }
  double textWidth() const { return textWidth_; }
  double textHeight() const { return textHeight_; }
  double maxHorizontalAdvance() const { return maxHorizontalAdvance_; }
  double underlinePosition() const { return underlinePosition_; }
  double underlineThickness() const { return underlineThickness_; }

  double ascent_, descent_, textWidth_, textHeight_,
      maxHorizontalAdvance_, underlinePosition_, underlineThickness_;
};

class ChannelStatistics {
 public:
  ChannelStatistics()
      : channel_(CompositePixelChannel), mean_(0), standardDeviation_(0),
        minima_(0), maxima_(0), variance_(0), skewness_(0), kurtosis_(0),
        entropy_(0), sum_(0), area_(0), depth_(8) {}
  PixelChannel channel() const { return channel_; }
  double mean() const { return mean_; }
  double standardDeviation() const { return standardDeviation_; }
  double minima() const { return minima_; }
  double maxima() const { return maxima_; }
  double variance() const { return variance_; }
  double skewness() const { return skewness_; }
  double kurtosis() const { return kurtosis_; }
  double entropy() const { return entropy_; }
  double sum() const { return sum_; }
  double area() const { return area_; }
  size_t depth() const { return depth_; }

  PixelChannel channel_;
  double mean_, standardDeviation_, minima_, maxima_, variance_,
      skewness_, kurtosis_, entropy_, sum_, area_;
  size_t depth_;
};

class ImageStatistics {
 public:
  ChannelStatistics channel(
      const PixelChannel channel = CompositePixelChannel) const;
  std::vector<ChannelStatistics> channels_;
};

class ChannelMoments {
 public:
  ChannelMoments() : channel_(CompositePixelChannel), centroidX_(0),
                     centroidY_(0), ellipseIntensity_(0) {
    for (int i = 0; i < 8; i++) huInvariants_[i] = 0.0;
  }
  PixelChannel channel() const { return channel_; }
  double centroidX() const { return centroidX_; }
  double centroidY() const { return centroidY_; }
  double ellipseIntensity() const { return ellipseIntensity_; }
  double huInvariants(size_t i) const { return huInvariants_[i % 8]; }

  PixelChannel channel_;
  double centroidX_, centroidY_, ellipseIntensity_, huInvariants_[8];
};

class ImageMoments {
 public:
  ChannelMoments channel(
      const PixelChannel channel = CompositePixelChannel) const;
  std::vector<ChannelMoments> channels_;
};

class ImagePerceptualHash {
 public:
  double sumSquaredDifferences(const ImagePerceptualHash& other) const;
  bool isValid() const { return !hash_.empty(); }
  std::vector<double> hash_;
};

// ---------------------------------------------------------------------------
// Exceptions (Magick++/lib/Magick++/Exception.h)
// ---------------------------------------------------------------------------

class Exception : public std::exception {
 public:
  explicit Exception(const std::string& what) : what_(what) {}
  ~Exception() throw() {}
  const char* what() const throw() { return what_.c_str(); }

 private:
  std::string what_;
};

class Error : public Exception {
 public:
  explicit Error(const std::string& what) : Exception(what) {}
};
class Warning : public Exception {
 public:
  explicit Warning(const std::string& what) : Exception(what) {}
};
class ErrorOption : public Error {
 public:
  explicit ErrorOption(const std::string& what) : Error(what) {}
};
class ErrorBlob : public Error {
 public:
  explicit ErrorBlob(const std::string& what) : Error(what) {}
};

// ---------------------------------------------------------------------------
// Geometry (Magick++/lib/Magick++/Geometry.h; string grammar per
// MagickCore/geometry.c ParseGeometry: WxH+X+Y with %^!<>@ flags)
// ---------------------------------------------------------------------------

class Geometry {
 public:
  Geometry();
  Geometry(size_t width, size_t height, magickpp_ssize_t xOff = 0,
           magickpp_ssize_t yOff = 0);
  Geometry(const std::string& geometry);
  Geometry(const char* geometry);

  size_t width() const { return width_; }
  void width(size_t w) { width_ = w; isValid_ = true; }
  size_t height() const { return height_; }
  void height(size_t h) { height_ = h; isValid_ = true; }
  magickpp_ssize_t xOff() const { return xOff_; }
  void xOff(magickpp_ssize_t x) { xOff_ = x; }
  magickpp_ssize_t yOff() const { return yOff_; }
  void yOff(magickpp_ssize_t y) { yOff_ = y; }

  bool percent() const { return percent_; }
  void percent(bool p) { percent_ = p; }
  bool aspect() const { return aspect_; }          // '!'
  void aspect(bool a) { aspect_ = a; }
  bool greater() const { return greater_; }        // '>'
  void greater(bool g) { greater_ = g; }
  bool less() const { return less_; }              // '<'
  void less(bool l) { less_ = l; }
  bool fillArea() const { return fillArea_; }      // '^'
  void fillArea(bool f) { fillArea_ = f; }
  bool limitPixels() const { return limitPixels_; }  // '@'
  void limitPixels(bool l) { limitPixels_ = l; }

  bool isValid() const { return isValid_; }
  void isValid(bool v) { isValid_ = v; }

  operator std::string() const;  // format back to "WxH+X+Y" + flags

 private:
  void parse(const std::string& geometry);

  size_t width_, height_;
  magickpp_ssize_t xOff_, yOff_;
  bool percent_, aspect_, greater_, less_, fillArea_, limitPixels_;
  bool isValid_;
};

// ---------------------------------------------------------------------------
// Color (Magick++/lib/Magick++/Color.h) — components are Quantum-scaled
// doubles in [0, QuantumRange]; named colors resolve through the
// framework's color database (core/color.py, MagickCore/color.c table).
// ---------------------------------------------------------------------------

class Color {
 public:
  Color();
  Color(double red, double green, double blue);           // Quantum scale
  Color(double red, double green, double blue, double alpha);
  Color(const std::string& name);
  Color(const char* name);

  double quantumRed() const { return r_ * QuantumRange; }
  double quantumGreen() const { return g_ * QuantumRange; }
  double quantumBlue() const { return b_ * QuantumRange; }
  double quantumAlpha() const { return a_ * QuantumRange; }
  void quantumRed(double q) { r_ = q / QuantumRange; valid_ = true; }
  void quantumGreen(double q) { g_ = q / QuantumRange; valid_ = true; }
  void quantumBlue(double q) { b_ = q / QuantumRange; valid_ = true; }
  void quantumAlpha(double q) { a_ = q / QuantumRange; valid_ = true; }

  bool isValid() const { return valid_; }
  operator std::string() const;  // "rgba(r,g,b,a)" 0-255 / 0-1 form

  bool operator==(const Color& other) const;
  bool operator!=(const Color& other) const { return !(*this == other); }

  // normalized [0,1] accessors (framework-native scale)
  double red() const { return r_; }
  double green() const { return g_; }
  double blue() const { return b_; }
  double alpha() const { return a_; }

 private:
  double r_, g_, b_, a_;
  bool valid_;
};

class ColorRGB : public Color {
 public:
  ColorRGB(double red, double green, double blue)
      : Color(red * QuantumRange, green * QuantumRange, blue * QuantumRange) {}
};

class ColorGray : public Color {
 public:
  explicit ColorGray(double shade)
      : Color(shade * QuantumRange, shade * QuantumRange,
              shade * QuantumRange) {}
};

class ColorMono : public Color {
 public:
  explicit ColorMono(bool white)
      : Color(white ? QuantumRange : 0, white ? QuantumRange : 0,
              white ? QuantumRange : 0) {}
};

// ---------------------------------------------------------------------------
// Blob (Magick++/lib/Magick++/Blob.h)
// ---------------------------------------------------------------------------

class Blob {
 public:
  Blob() {}
  Blob(const void* data, size_t length)
      : data_(static_cast<const unsigned char*>(data),
              static_cast<const unsigned char*>(data) + length) {}

  void update(const void* data, size_t length) {
    data_.assign(static_cast<const unsigned char*>(data),
                 static_cast<const unsigned char*>(data) + length);
  }
  const void* data() const { return data_.empty() ? 0 : &data_[0]; }
  size_t length() const { return data_.size(); }

 private:
  std::vector<unsigned char> data_;
};

// ---------------------------------------------------------------------------
// Image (Magick++/lib/Magick++/Image.h) — every method dispatches onto the
// embedded framework's MagickWand (wand/api.py).
// ---------------------------------------------------------------------------

struct ImageRef;  // pimpl: hides PyObject* from the public header

class Image {
 public:
  Image();
  Image(const std::string& imageSpec);               // read on construct
  Image(const Geometry& size, const Color& color);   // solid canvas
  explicit Image(const Blob& blob);
  Image(const Image& other);                          // deep copy (clone)
  Image& operator=(const Image& other);
  ~Image();

  // --- I/O ---
  void read(const std::string& imageSpec);
  void read(const Blob& blob);
  void read(const Geometry& size, const std::string& imageSpec);
  void ping(const std::string& imageSpec);
  void write(const std::string& imageSpec);
  void write(Blob* blob);
  void write(Blob* blob, const std::string& magick);

  // --- attributes ---
  size_t columns() const;
  size_t rows() const;
  Geometry size() const;
  void size(const Geometry& g);                       // canvas resize/extent
  size_t depth() const;
  void depth(size_t d);
  std::string magick() const;
  void magick(const std::string& m);
  std::string fileName() const;
  void fileName(const std::string& name);
  size_t quality() const;
  void quality(size_t q);
  ColorspaceType colorSpace() const;
  void colorSpace(ColorspaceType cs);
  std::string colorSpaceName() const;
  ImageType type() const;
  void type(ImageType t);
  bool alpha() const;
  void alpha(bool enable);
  void alphaChannel(AlphaChannelOption option);
  double colorFuzz() const;
  void colorFuzz(double fuzz);
  Color backgroundColor() const;
  void backgroundColor(const Color& c);
  Color borderColor() const;
  void borderColor(const Color& c);
  Color matteColor() const;
  void matteColor(const Color& c);
  std::string font() const;
  void font(const std::string& f);
  double fontPointsize() const;
  void fontPointsize(double p);
  FilterType filterType() const;
  void filterType(FilterType f);
  GravityType gravity() const;
  void gravity(GravityType g);
  std::string label() const;
  void label(const std::string& l);
  std::string comment() const;
  void comment(const std::string& c);
  OrientationType orientation() const;
  void orientation(OrientationType o);
  Geometry page() const;
  void page(const Geometry& g);
  size_t animationDelay() const;
  void animationDelay(size_t d);
  double gamma() const;
  size_t totalColors() const;
  std::string signature() const;
  std::string attribute(const std::string& name) const;
  void attribute(const std::string& name, const std::string& value);
  std::string artifact(const std::string& name) const;
  void artifact(const std::string& name, const std::string& value);
  void defineValue(const std::string& magick, const std::string& key,
                   const std::string& value);
  std::string defineValue(const std::string& magick,
                          const std::string& key) const;
  Geometry boundingBox() const;
  size_t fileSize() const;
  std::string format() const;  // descriptive format name
  double xResolution() const;
  double yResolution() const;
  void resolutionUnits(const std::string& units);
  void density(const Geometry& g);

  // --- profiles / metadata ---
  void profile(const std::string& name, const Blob& profileBlob);
  Blob profile(const std::string& name) const;
  Blob exifProfile() const;
  Blob iccColorProfile() const;
  void strip();

  // --- geometry ops ---
  void resize(const Geometry& g);
  void resize(const Geometry& g, FilterType filter);
  void adaptiveResize(const Geometry& g);
  void scale(const Geometry& g);
  void sample(const Geometry& g);
  void thumbnail(const Geometry& g);
  void zoom(const Geometry& g);
  void magnify();
  void minify();
  void liquidRescale(const Geometry& g);
  void crop(const Geometry& g);
  void chop(const Geometry& g);
  void extent(const Geometry& g);
  void extent(const Geometry& g, const Color& background);
  void extent(const Geometry& g, GravityType gravity);
  void shave(const Geometry& g);
  void splice(const Geometry& g);
  void roll(const Geometry& roll);
  void roll(size_t columns, size_t rows);
  void trim();
  void border(const Geometry& g);
  void frame(const Geometry& g);
  void flip();
  void flop();
  void transpose();
  void transverse();
  void rotate(double degrees);
  void shear(double xShear, double yShear);
  void deskew(double threshold);
  void autoOrient();
  void repage();

  // --- filters / effects ---
  void blur(double radius = 0.0, double sigma = 1.0);
  void gaussianBlur(double radius, double sigma);
  void adaptiveBlur(double radius = 0.0, double sigma = 1.0);
  void motionBlur(double radius, double sigma, double angle);
  void rotationalBlur(double angle);
  void selectiveBlur(double radius, double sigma, double threshold);
  void sharpen(double radius = 0.0, double sigma = 1.0);
  void adaptiveSharpen(double radius = 0.0, double sigma = 1.0);
  void unsharpmask(double radius, double sigma, double amount,
                   double threshold);
  void despeckle();
  void reduceNoise();
  void reduceNoise(size_t order);
  void medianFilter(double radius = 0.0);
  void edge(double radius = 0.0);
  void emboss(double radius = 0.0, double sigma = 1.0);
  void shade(double azimuth = 30, double elevation = 30,
             bool colorShading = false);
  void spread(double amount = 3.0);
  void charcoal(double radius = 0.0, double sigma = 1.0);
  void oilPaint(double radius = 3.0);
  void sketch(double radius = 0.0, double sigma = 1.0, double angle = 0.0);
  void vignette(double radius = 0.0, double sigma = 10.0,
                magickpp_ssize_t x = 0, magickpp_ssize_t y = 0);
  void wave(double amplitude = 25.0, double wavelength = 150.0);
  void swirl(double degrees);
  void implode(double factor);
  void solarize(double factor = 50.0);
  void sepiaTone(double threshold);
  void blueShift(double factor = 1.5);
  void addNoise(NoiseType noiseType, double attenuate = 1.0);
  void colorize(unsigned int alpha, const Color& penColor);
  void tint(const std::string& opacity, const Color& penColor);
  void shadow(double alpha = 80.0, double sigma = 3.0,
              magickpp_ssize_t x = 5, magickpp_ssize_t y = 5);
  void polaroid(const std::string& caption, double angle);
  void waveletDenoise(double threshold, double softness);
  void kuwahara(double radius = 1.0, double sigma = 0.0);
  void localContrast(double radius, double strength);
  void convolve(size_t order, const double* kernel);

  // --- channel-scoped variants (ChannelType restricts the effect) ---
  void blurChannel(ChannelType ch, double radius = 0.0, double sigma = 1.0);
  void gaussianBlurChannel(ChannelType ch, double radius, double sigma);
  void sharpenChannel(ChannelType ch, double radius = 0.0,
                      double sigma = 1.0);
  void adaptiveSharpenChannel(ChannelType ch, double radius = 0.0,
                              double sigma = 1.0);
  void negateChannel(ChannelType ch, bool grayscale = false);
  void gammaChannel(ChannelType ch, double g);
  void levelChannel(ChannelType ch, double blackPoint, double whitePoint,
                    double gamma = 1.0);
  void autoLevelChannel(ChannelType ch);
  void autoGammaChannel(ChannelType ch);
  void brightnessContrastChannel(ChannelType ch, double brightness,
                                 double contrast);
  void contrastStretchChannel(ChannelType ch, double blackPoint,
                              double whitePoint);
  void sigmoidalContrastChannel(ChannelType ch, bool sharpen,
                                double contrast,
                                double midpoint = QuantumRange / 2.0);
  void addNoiseChannel(ChannelType ch, NoiseType noiseType);
  void clampChannel(ChannelType ch);
  void randomThresholdChannel(ChannelType ch, double low, double high);
  void equalizeChannel(ChannelType ch);
  void morphology(MorphologyMethod method, const std::string& kernel,
                  magickpp_ssize_t iterations = 1);
  void statistic(const std::string& type, size_t width, size_t height);

  // --- enhancement ---
  void normalize();
  void equalize();
  void autoLevel();
  void autoGamma();
  void gamma(double g);
  void gamma(double r, double g, double b);
  void level(double blackPoint, double whitePoint, double gamma = 1.0);
  void levelize(double blackPoint, double whitePoint, double gamma = 1.0);
  void negate(bool grayscale = false);
  void modulate(double brightness, double saturation, double hue);
  void brightnessContrast(double brightness = 0.0, double contrast = 0.0);
  void contrast(bool sharpen);
  void contrastStretch(double blackPoint, double whitePoint);
  void linearStretch(double blackPoint, double whitePoint);
  void sigmoidalContrast(bool sharpen, double contrast,
                         double midpoint = QuantumRange / 2.0);
  void clahe(size_t width, size_t height, size_t bins, double clipLimit);
  void enhance();
  void whiteBalance();
  void cdl(const std::string& cdl);

  // --- thresholds / quantization ---
  void threshold(double t);
  void blackThreshold(const std::string& t);
  void whiteThreshold(const std::string& t);
  void adaptiveThreshold(size_t width, size_t height, double bias = 0.0);
  void autoThreshold(AutoThresholdMethod method);
  void randomThreshold(double low, double high);
  void orderedDither(const std::string& thresholdMap);
  void posterize(size_t levels, bool dither = false);
  void quantize(bool measureError = false);
  size_t quantizeColors() const;
  void quantizeColors(size_t n);
  bool quantizeDither() const;
  void quantizeDither(bool d);
  void segment(double clusterThreshold = 1.0,
               double smoothingThreshold = 1.5);
  void clamp();

  // --- color ---
  void opaque(const Color& target, const Color& fill);
  void transparent(const Color& target, double alpha = 0.0);
  void floodFillColor(const Geometry& point, const Color& fill,
                      double fuzz = 0.0);
  Color pixelColor(magickpp_ssize_t x, magickpp_ssize_t y) const;
  void pixelColor(magickpp_ssize_t x, magickpp_ssize_t y, const Color& c);
  void colorMatrix(size_t order, const double* matrix);
  void cycleColormap(magickpp_ssize_t amount);

  // --- composition / drawing / annotation ---
  void composite(const Image& compositeImage, magickpp_ssize_t x,
                 magickpp_ssize_t y,
                 CompositeOperator compose = InCompositeOp);
  void composite(const Image& compositeImage, const Geometry& offset,
                 CompositeOperator compose = InCompositeOp);
  void composite(const Image& compositeImage, GravityType gravity,
                 CompositeOperator compose = InCompositeOp);
  void draw(const std::string& mvg);  // MVG primitive string
  void draw(const Drawable& drawable);
  void draw(const DrawableList& drawables);
  void annotate(const std::string& text, const Geometry& location);
  void annotate(const std::string& text, GravityType gravity);
  void stegano(const Image& watermark);
  void stereo(const Image& rightImage);
  void texture(const Image& texture);

  // --- analysis ---
  double compare(const Image& reference, MetricType metric) const;
  bool compare(const Image& reference) const;
  void cannyEdge(double radius = 0.0, double sigma = 1.0,
                 double lowerPercent = 0.1, double upperPercent = 0.3);
  void connectedComponents(size_t connectivity);
  void meanShift(size_t width, size_t height, double colorDistance);
  double meanErrorPerPixel() const;
  double normalizedMaxError() const;
  double normalizedMeanError() const;

  // --- transforms / misc ---
  void distort(DistortMethod method, size_t numberArguments,
               const double* arguments, bool bestfit = false);
  void affineTransform(const double* sx_rx_ry_sy_tx_ty);
  void fx(const std::string& expression);
  void evaluate(EvaluateOperator op, double value);
  void encipher(const std::string& passphrase);
  void decipher(const std::string& passphrase);
  void transformColorSpace(ColorspaceType cs);
  void grayscale(const std::string& method = "rec709luma");
  void flatten();

  // --- attribute pairs (Options role; Magick++/lib/Image.cpp) ---
  void adjoin(const bool flag);
  bool adjoin() const;
  void animationIterations(const size_t iterations);
  size_t animationIterations() const;
  void backgroundTexture(const std::string& texture);
  std::string backgroundTexture() const;
  size_t baseColumns() const;
  std::string baseFilename() const;
  size_t baseRows() const;
  void blackPointCompensation(const bool flag);
  bool blackPointCompensation() const;
  void boxColor(const Color& c);
  Color boxColor() const;
  void classType(const ClassType cls);
  ClassType classType() const;
  size_t channels() const;
  void channelDepth(const ChannelType ch, const size_t depth);
  size_t channelDepth(const ChannelType ch);
  void colorMapSize(const size_t entries);
  size_t colorMapSize() const;
  void colorSpaceType(const ColorspaceType cs);
  ColorspaceType colorSpaceType() const;
  void compose(const CompositeOperator op);
  CompositeOperator compose() const;
  void compressType(const CompressionType t);
  CompressionType compressType() const;
  void debug(const bool flag);
  bool debug() const;
  void defineSet(const std::string& magick, const std::string& key,
                 bool flag);
  bool defineSet(const std::string& magick, const std::string& key) const;
  std::string directory() const;
  void endian(const EndianType e);
  EndianType endian() const;
  void fillColor(const Color& c);
  Color fillColor() const;
  void fillRule(const FillRule& rule);
  FillRule fillRule() const;
  void fillPattern(const Image& pattern);
  Image fillPattern() const;
  void fontFamily(const std::string& family);
  std::string fontFamily() const;
  void fontStyle(const StyleType style);
  StyleType fontStyle() const;
  void fontWeight(const size_t weight);
  size_t fontWeight() const;
  Geometry geometry() const;
  void gifDisposeMethod(const DisposeType d);
  DisposeType gifDisposeMethod() const;
  bool hasChannel(const PixelChannel channel) const;
  void highlightColor(const Color c);
  void lowlightColor(const Color c);
  void masklightColor(const Color c);
  void interlaceType(const InterlaceType i);
  InterlaceType interlaceType() const;
  void interpolate(const PixelInterpolateMethod m);
  PixelInterpolateMethod interpolate() const;
  void iptcProfile(const Blob& profile);
  Blob iptcProfile() const;
  bool isOpaque() const;
  void modulusDepth(const size_t depth);
  size_t modulusDepth() const;
  void monochrome(const bool flag);
  bool monochrome() const;
  Geometry montageGeometry() const;
  void quantizeColorSpace(const ColorspaceType cs);
  ColorspaceType quantizeColorSpace() const;
  void quantizeDitherMethod(const DitherMethod m);
  DitherMethod quantizeDitherMethod() const;
  void quantizeTreeDepth(const size_t depth);
  size_t quantizeTreeDepth() const;
  void quiet(const bool flag);
  bool quiet() const;
  void renderingIntent(const RenderingIntent intent);
  RenderingIntent renderingIntent() const;
  void samplingFactor(const std::string& factor);
  std::string samplingFactor() const;
  void scene(const size_t s);
  size_t scene() const;
  void strokeAntiAlias(const bool flag);
  bool strokeAntiAlias() const;
  void strokeColor(const Color& c);
  Color strokeColor() const;
  void strokeDashArray(const double* dashes);   // 0.0-terminated
  const double* strokeDashArray() const;
  void strokeDashOffset(const double off);
  double strokeDashOffset() const;
  void strokeLineCap(const LineCap cap);
  LineCap strokeLineCap() const;
  void strokeLineJoin(const LineJoin join);
  LineJoin strokeLineJoin() const;
  void strokeMiterLimit(const size_t limit);
  size_t strokeMiterLimit() const;
  void strokePattern(const Image& pattern);
  Image strokePattern() const;
  void strokeWidth(const double w);
  double strokeWidth() const;
  void subImage(const size_t idx);
  size_t subImage() const;
  void subRange(const size_t n);
  size_t subRange() const;
  void textAntiAlias(const bool flag);
  bool textAntiAlias() const;
  void textDirection(DirectionType d);
  DirectionType textDirection() const;
  void textEncoding(const std::string& encoding);
  std::string textEncoding() const;
  void textGravity(GravityType g);
  GravityType textGravity() const;
  void textInterlineSpacing(double spacing);
  double textInterlineSpacing() const;
  void textInterwordSpacing(double spacing);
  double textInterwordSpacing() const;
  void textKerning(double kerning);
  double textKerning() const;
  void textUnderColor(const Color& c);
  Color textUnderColor() const;
  void verbose(const bool flag);
  bool verbose() const;
  void virtualPixelMethod(const VirtualPixelMethod m);
  VirtualPixelMethod virtualPixelMethod() const;
  void x11Display(const std::string& display);
  std::string x11Display() const;
  void chromaBluePrimary(const double x, const double y, const double z);
  void chromaBluePrimary(double* x, double* y, double* z) const;
  void chromaGreenPrimary(const double x, const double y, const double z);
  void chromaGreenPrimary(double* x, double* y, double* z) const;
  void chromaRedPrimary(const double x, const double y, const double z);
  void chromaRedPrimary(double* x, double* y, double* z) const;
  void chromaWhitePoint(const double x, const double y, const double z);
  void chromaWhitePoint(double* x, double* y, double* z) const;

  // --- widened operations ---
  void channel(const ChannelType ch);
  void clip();
  void clipPath(const std::string pathname, const bool inside);
  void clut(const Image& clutImage,
            const PixelInterpolateMethod method = UndefinedInterpolatePixel);
  void clutChannel(const ChannelType ch, const Image& clutImage,
                   const PixelInterpolateMethod method =
                       UndefinedInterpolatePixel);
  void colorMap(const size_t index, const Color& color);
  Color colorMap(const size_t index) const;
  double compareChannel(const ChannelType ch, const Image& reference,
                        const MetricType metric);
  void copyPixels(const Image& source, const Geometry& geometry,
                  const Offset& offset);
  void display();
  void erase();
  void floodFillAlpha(const magickpp_ssize_t x, const magickpp_ssize_t y,
                      const unsigned int alpha, const bool invert = false);
  void floodFillTexture(const magickpp_ssize_t x, const magickpp_ssize_t y,
                        const Image& texture, const bool invert = false);
  void fontTypeMetrics(const std::string& text, TypeMetric* metrics);
  void fontTypeMetricsMultiline(const std::string& text,
                                TypeMetric* metrics);
  std::string formatExpression(const std::string expression);
  void haldClut(const Image& clutImage);
  void houghLine(const size_t width, const size_t height,
                 const size_t threshold = 40);
  ImageType identifyType() const;
  void inverseFourierTransform(const Image& phase);
  void inverseFourierTransform(const Image& phase, const bool magnitude);
  void levelColors(const Color& blackColor, const Color& whiteColor,
                   const bool invert = true);
  void levelColorsChannel(const ChannelType ch, const Color& blackColor,
                          const Color& whiteColor, const bool invert = true);
  void map(const Image& mapImage, const bool dither = false);
  void map(const Image& mapImage, const DitherMethod ditherMethod);
  void modifyImage();
  ImageMoments moments() const;
  void morphologyChannel(const ChannelType ch, const MorphologyMethod m,
                         const std::string kernel,
                         const magickpp_ssize_t iterations = 1);
  void perceptible(const double epsilon);
  ImagePerceptualHash perceptualHash() const;
  void process(std::string name, const magickpp_ssize_t argc,
               const char** argv);
  void raise(const Geometry& geometry = Geometry(6, 6),
             const bool raisedFlag = false);
  void readMask(const Image& mask);
  Image readMask() const;
  void writeMask(const Image& mask);
  Image writeMask() const;
  void resample(const Point& density);
  Image separate(const ChannelType ch) const;
  bool setColorMetric(const Image& reference);
  void sparseColor(const ChannelType ch, const SparseColorMethod method,
                   const size_t numberArguments, const double* arguments);
  ImageStatistics statistics() const;
  Image subImageSearch(const Image& reference, const MetricType metric,
                       Geometry* offset, double* similarityMetric,
                       const double similarityThreshold = -1.0);
  void transformOrigin(const double x, const double y);
  void transformReset();
  void transformRotation(const double angle);
  void transformScale(const double sx, const double sy);
  void transformSkewX(const double skewx);
  void transformSkewY(const double skewy);
  void transparentChroma(const Color& colorLow, const Color& colorHigh);
  Image uniqueColors() const;

  // --- widened channel variants ---
  void blackThresholdChannel(const ChannelType ch,
                             const std::string& threshold);
  void whiteThresholdChannel(const ChannelType ch,
                             const std::string& threshold);
  void charcoalChannel(const ChannelType ch, const double radius = 0.0,
                       const double sigma = 1.0);
  void kuwaharaChannel(const ChannelType ch, const double radius = 0.0,
                       const double sigma = 1.0);
  void levelizeChannel(const ChannelType ch, const double blackPoint,
                       const double whitePoint, const double gamma = 1.0);
  void localContrastChannel(const ChannelType ch, const double radius,
                            const double strength);
  void orderedDitherChannel(const ChannelType ch,
                            std::string thresholdMap);
  void perceptibleChannel(const ChannelType ch, const double epsilon);
  void posterizeChannel(const ChannelType ch, const size_t levels,
                        const DitherMethod method);
  void rotationalBlurChannel(const ChannelType ch, const double angle);
  void selectiveBlurChannel(const ChannelType ch, const double radius,
                            const double sigma, const double threshold);
  void unsharpmaskChannel(const ChannelType ch, const double radius,
                          const double sigma, const double amount,
                          const double threshold);

  // --- pixel access (Magick++/lib/Magick++/Pixels.h role) ---
  // Returns an RGBA float32 buffer (normalized [0,1]) owned by the Image;
  // valid until the next mutating call.  syncPixels() writes it back.
  const float* getConstPixels(magickpp_ssize_t x, magickpp_ssize_t y,
                              size_t width, size_t height) const;
  float* getPixels(magickpp_ssize_t x, magickpp_ssize_t y, size_t width,
                   size_t height);
  void syncPixels();
  void readPixels(StorageType storage, const std::string& map,
                  const void* pixels);
  void writePixels(StorageType storage, const std::string& map,
                   void* pixels) const;

  bool isValid() const;

  ImageRef* ref() const { return ref_; }         // internal
  static Image _fromWand(void* pyWand);          // internal: adopt a wand

 private:
  ImageRef* ref_;
};

// ---------------------------------------------------------------------------
// STL-style multi-image functions (Magick++/lib/Magick++/STL.h)
// ---------------------------------------------------------------------------

void readImages(std::vector<Image>* sequence, const std::string& imageSpec);
void writeImages(const std::vector<Image>& sequence,
                 const std::string& imageSpec, bool adjoin = true);
void appendImages(Image* appended, const std::vector<Image>& sequence,
                  bool stack = false);
void averageImages(Image* averaged, const std::vector<Image>& sequence);
void flattenImages(Image* flattened, const std::vector<Image>& sequence);
void mosaicImages(Image* mosaic, const std::vector<Image>& sequence);
void montageImages(Image* montage, const std::vector<Image>& sequence,
                   const std::string& tile = "",
                   const std::string& geometry = "120x120+4+3");
void coalesceImages(std::vector<Image>* out,
                    const std::vector<Image>& sequence);
void deconstructImages(std::vector<Image>* out,
                       const std::vector<Image>& sequence);
void morphImages(std::vector<Image>* out, const std::vector<Image>& sequence,
                 size_t frames);

// ---------------------------------------------------------------------------
// ResourceLimits (Magick++/lib/Magick++/ResourceLimits.h) — static facade
// over the framework's resource manager (core/resource.py)
// ---------------------------------------------------------------------------

class ResourceLimits {
 public:
  static unsigned long long memory();
  static void memory(unsigned long long limit);
  static unsigned long long map();
  static void map(unsigned long long limit);
  static unsigned long long disk();
  static void disk(unsigned long long limit);
  static unsigned long long area();
  static void area(unsigned long long limit);
  static unsigned long long width();
  static void width(unsigned long long limit);
  static unsigned long long height();
  static void height(unsigned long long limit);
  static unsigned long long thread();
  static void thread(unsigned long long limit);

 private:
  ResourceLimits();
};

// ---------------------------------------------------------------------------
// CoderInfo (Magick++/lib/Magick++/CoderInfo.h)
// ---------------------------------------------------------------------------

class CoderInfo {
 public:
  explicit CoderInfo(const std::string& name);
  std::string name() const { return name_; }
  bool isReadable() const { return readable_; }
  bool isWritable() const { return writable_; }
  bool isMultiFrame() const { return multiframe_; }

 private:
  friend void coderInfoList(std::vector<CoderInfo>* out);
  CoderInfo() : readable_(false), writable_(false), multiframe_(false) {}
  std::string name_;
  bool readable_, writable_, multiframe_;
};

void coderInfoList(std::vector<CoderInfo>* out);

// ---------------------------------------------------------------------------
// Functions (Magick++/lib/Magick++/Functions.h)
// ---------------------------------------------------------------------------

// `device` is where every image lives: a torch device string ("cuda",
// "cuda:1", "cpu").
void InitializeMagick(const char* path = 0,
                      const char* device = MAGICKPP_DEVICE);
void TerminateMagick();

// Enum <-> framework-string conversion helpers (internal but exported for
// tests): the framework speaks lowercase option strings everywhere.
std::string toString(FilterType f);
std::string toString(CompositeOperator op);
std::string toString(ColorspaceType cs);
std::string toString(GravityType g);
std::string toString(NoiseType n);
std::string toString(MetricType m);
std::string toString(DistortMethod d);
std::string toString(MorphologyMethod m);

}  // namespace Magick

#endif  // MAGICKPP_TORCH_H
