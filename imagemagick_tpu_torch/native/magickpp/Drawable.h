// Drawable object layer for the Magick++ compatibility API.
//
// Mirrors the reference's Magick++/lib/Magick++/Drawable.h: each Drawable
// is a value object representing one MVG drawing primitive or graphic-
// context mutation.  Here every Drawable renders itself to an MVG text
// fragment at construction; Image::draw(const DrawableList&) joins the
// fragments and hands the program to the framework's MVG interpreter
// (ops/draw.py), so the semantics match the string-MVG path exactly.
//
// Included automatically by Magick++.h.

#ifndef MAGICKPP_TORCH_DRAWABLE_H
#define MAGICKPP_TORCH_DRAWABLE_H

#include <cstdio>
#include <list>
#include <sstream>
#include <string>
#include <vector>

namespace Magick {

class Coordinate {
 public:
  Coordinate() : x_(0), y_(0) {}
  Coordinate(double x, double y) : x_(x), y_(y) {}
  double x() const { return x_; }
  double y() const { return y_; }
  void x(double v) { x_ = v; }
  void y(double v) { y_ = v; }

 private:
  double x_, y_;
};

typedef std::vector<Coordinate> CoordinateList;

// Base value type: wraps a rendered MVG fragment.
class Drawable {
 public:
  Drawable() {}
  explicit Drawable(const std::string& mvg) : mvg_(mvg) {}
  const std::string& mvg() const { return mvg_; }

 protected:
  static std::string num(double v) {
    char buf[40];
    snprintf(buf, sizeof(buf), "%g", v);
    return buf;
  }
  static std::string coords(const CoordinateList& c) {
    std::ostringstream o;
    for (size_t i = 0; i < c.size(); i++)
      o << (i ? " " : "") << num(c[i].x()) << "," << num(c[i].y());
    return o.str();
  }
  static std::string quote(const std::string& s) {
    std::string out = "\"";
    for (size_t i = 0; i < s.size(); i++) {
      if (s[i] == '"' || s[i] == '\\') out += '\\';
      out += s[i];
    }
    return out + "\"";
  }
  std::string mvg_;
};

typedef std::list<Drawable> DrawableList;

// --- shape primitives (draw.c MVG grammar) ---

class DrawablePoint : public Drawable {
 public:
  DrawablePoint(double x, double y)
      : Drawable("point " + num(x) + "," + num(y)) {}
};

class DrawableLine : public Drawable {
 public:
  DrawableLine(double sx, double sy, double ex, double ey)
      : Drawable("line " + num(sx) + "," + num(sy) + " " + num(ex) + "," +
                 num(ey)) {}
};

class DrawableRectangle : public Drawable {
 public:
  DrawableRectangle(double ulx, double uly, double lrx, double lry)
      : Drawable("rectangle " + num(ulx) + "," + num(uly) + " " + num(lrx) +
                 "," + num(lry)) {}
};

class DrawableRoundRectangle : public Drawable {
 public:
  DrawableRoundRectangle(double ulx, double uly, double lrx, double lry,
                         double cw, double ch)
      : Drawable("roundrectangle " + num(ulx) + "," + num(uly) + " " +
                 num(lrx) + "," + num(lry) + " " + num(cw) + "," + num(ch)) {}
};

class DrawableCircle : public Drawable {
 public:
  DrawableCircle(double ox, double oy, double px, double py)
      : Drawable("circle " + num(ox) + "," + num(oy) + " " + num(px) + "," +
                 num(py)) {}
};

class DrawableEllipse : public Drawable {
 public:
  DrawableEllipse(double ox, double oy, double rx, double ry, double start,
                  double end)
      : Drawable("ellipse " + num(ox) + "," + num(oy) + " " + num(rx) + "," +
                 num(ry) + " " + num(start) + "," + num(end)) {}
};

class DrawableArc : public Drawable {
 public:
  DrawableArc(double sx, double sy, double ex, double ey, double sd,
              double ed)
      : Drawable("arc " + num(sx) + "," + num(sy) + " " + num(ex) + "," +
                 num(ey) + " " + num(sd) + "," + num(ed)) {}
};

class DrawablePolygon : public Drawable {
 public:
  explicit DrawablePolygon(const CoordinateList& c)
      : Drawable("polygon " + coords(c)) {}
};

class DrawablePolyline : public Drawable {
 public:
  explicit DrawablePolyline(const CoordinateList& c)
      : Drawable("polyline " + coords(c)) {}
};

class DrawableBezier : public Drawable {
 public:
  explicit DrawableBezier(const CoordinateList& c)
      : Drawable("bezier " + coords(c)) {}
};

class DrawablePath : public Drawable {
 public:
  explicit DrawablePath(const std::string& svgPath)
      : Drawable("path '" + svgPath + "'") {}
};

class DrawableText : public Drawable {
 public:
  DrawableText(double x, double y, const std::string& text)
      : Drawable("text " + num(x) + "," + num(y) + " " + quote(text)) {}
};

class DrawableColor : public Drawable {
 public:
  // paint method: point/replace/floodfill/filltoborder/reset
  DrawableColor(double x, double y, const std::string& paintMethod)
      : Drawable("color " + num(x) + "," + num(y) + " " + paintMethod) {}
};

class DrawableCompositeImage : public Drawable {
 public:
  DrawableCompositeImage(double x, double y, double width, double height,
                         const std::string& filename)
      : Drawable("image over " + num(x) + "," + num(y) + " " + num(width) +
                 "," + num(height) + " " + quote(filename)) {}
};

// --- graphic-context state ---

class DrawableFillColor : public Drawable {
 public:
  explicit DrawableFillColor(const std::string& color)
      : Drawable("fill " + color) {}
};

class DrawableStrokeColor : public Drawable {
 public:
  explicit DrawableStrokeColor(const std::string& color)
      : Drawable("stroke " + color) {}
};

class DrawableStrokeWidth : public Drawable {
 public:
  explicit DrawableStrokeWidth(double w)
      : Drawable("stroke-width " + num(w)) {}
};

class DrawableFillOpacity : public Drawable {
 public:
  explicit DrawableFillOpacity(double o)
      : Drawable("fill-opacity " + num(o)) {}
};

class DrawableStrokeOpacity : public Drawable {
 public:
  explicit DrawableStrokeOpacity(double o)
      : Drawable("stroke-opacity " + num(o)) {}
};

class DrawableFillRule : public Drawable {
 public:
  explicit DrawableFillRule(const std::string& rule)  // evenodd | nonzero
      : Drawable("fill-rule " + rule) {}
};

class DrawableStrokeLineCap : public Drawable {
 public:
  explicit DrawableStrokeLineCap(const std::string& cap)
      : Drawable("stroke-linecap " + cap) {}
};

class DrawableStrokeLineJoin : public Drawable {
 public:
  explicit DrawableStrokeLineJoin(const std::string& join)
      : Drawable("stroke-linejoin " + join) {}
};

class DrawableMiterLimit : public Drawable {
 public:
  explicit DrawableMiterLimit(unsigned int limit)
      : Drawable("stroke-miterlimit " + num(limit)) {}
};

class DrawableStrokeDashArray : public Drawable {
 public:
  explicit DrawableStrokeDashArray(const std::vector<double>& dashes)
      : Drawable() {
    std::ostringstream o;
    o << "stroke-dasharray ";
    for (size_t i = 0; i < dashes.size(); i++)
      o << (i ? "," : "") << num(dashes[i]);
    if (dashes.empty()) o << "none";
    mvg_ = o.str();
  }
};

class DrawableStrokeDashOffset : public Drawable {
 public:
  explicit DrawableStrokeDashOffset(double off)
      : Drawable("stroke-dashoffset " + num(off)) {}
};

class DrawableFont : public Drawable {
 public:
  explicit DrawableFont(const std::string& font)
      : Drawable("font " + quote(font)) {}
};

class DrawablePointSize : public Drawable {
 public:
  explicit DrawablePointSize(double size)
      : Drawable("font-size " + num(size)) {}
};

class DrawableTextDecoration : public Drawable {
 public:
  explicit DrawableTextDecoration(const std::string& d)
      : Drawable("decorate " + d) {}
};

class DrawableTextAlignment : public Drawable {
 public:
  explicit DrawableTextAlignment(const std::string& a)  // left|center|right
      : Drawable("text-align " + a) {}
};

class DrawableTextUnderColor : public Drawable {
 public:
  explicit DrawableTextUnderColor(const std::string& c)
      : Drawable("text-undercolor " + c) {}
};

class DrawableTextAntialias : public Drawable {
 public:
  explicit DrawableTextAntialias(bool on)
      : Drawable(std::string("text-antialias ") + (on ? "1" : "0")) {}
};

class DrawableStrokeAntialias : public Drawable {
 public:
  explicit DrawableStrokeAntialias(bool on)
      : Drawable(std::string("stroke-antialias ") + (on ? "1" : "0")) {}
};

class DrawableGravity : public Drawable {
 public:
  explicit DrawableGravity(const std::string& g)
      : Drawable("gravity " + g) {}
};

class DrawableAlpha : public Drawable {
 public:
  DrawableAlpha(double x, double y, const std::string& paintMethod)
      : Drawable("alpha " + num(x) + "," + num(y) + " " + paintMethod) {}
};

class DrawableBorderColor : public Drawable {
 public:
  explicit DrawableBorderColor(const std::string& c)
      : Drawable("border-color " + c) {}
};

// --- coordinate transforms ---

class DrawableTranslation : public Drawable {
 public:
  DrawableTranslation(double x, double y)
      : Drawable("translate " + num(x) + "," + num(y)) {}
};

class DrawableRotation : public Drawable {
 public:
  explicit DrawableRotation(double angle)
      : Drawable("rotate " + num(angle)) {}
};

class DrawableScaling : public Drawable {
 public:
  DrawableScaling(double x, double y)
      : Drawable("scale " + num(x) + "," + num(y)) {}
};

class DrawableSkewX : public Drawable {
 public:
  explicit DrawableSkewX(double angle) : Drawable("skewX " + num(angle)) {}
};

class DrawableSkewY : public Drawable {
 public:
  explicit DrawableSkewY(double angle) : Drawable("skewY " + num(angle)) {}
};

class DrawableAffine : public Drawable {
 public:
  DrawableAffine(double sx, double rx, double ry, double sy, double tx,
                 double ty)
      : Drawable("affine " + num(sx) + "," + num(rx) + "," + num(ry) + "," +
                 num(sy) + "," + num(tx) + "," + num(ty)) {}
};

// --- context stack / patterns / clip paths ---

class DrawablePushGraphicContext : public Drawable {
 public:
  DrawablePushGraphicContext() : Drawable("push graphic-context") {}
};

class DrawablePopGraphicContext : public Drawable {
 public:
  DrawablePopGraphicContext() : Drawable("pop graphic-context") {}
};

class DrawablePushPattern : public Drawable {
 public:
  DrawablePushPattern(const std::string& id, double x, double y, double w,
                      double h)
      : Drawable("push pattern " + id + " " + num(x) + "," + num(y) + " " +
                 num(w) + "," + num(h)) {}
};

class DrawablePopPattern : public Drawable {
 public:
  DrawablePopPattern() : Drawable("pop pattern") {}
};

class DrawableFillPatternUrl : public Drawable {
 public:
  explicit DrawableFillPatternUrl(const std::string& url)
      : Drawable("fill " + url) {}
};

class DrawableStrokePatternUrl : public Drawable {
 public:
  explicit DrawableStrokePatternUrl(const std::string& url)
      : Drawable("stroke " + url) {}
};

class DrawablePushClipPath : public Drawable {
 public:
  explicit DrawablePushClipPath(const std::string& id)
      : Drawable("push clip-path " + id) {}
};

class DrawablePopClipPath : public Drawable {
 public:
  DrawablePopClipPath() : Drawable("pop clip-path") {}
};

class DrawableClipPath : public Drawable {
 public:
  explicit DrawableClipPath(const std::string& id)
      : Drawable("clip-path url(#" + id + ")") {}
};

class DrawableClipRule : public Drawable {
 public:
  explicit DrawableClipRule(const std::string& rule)
      : Drawable("clip-rule " + rule) {}
};

class DrawableViewbox : public Drawable {
 public:
  DrawableViewbox(long x1, long y1, long x2, long y2)
      : Drawable("viewbox " + num((double)x1) + " " + num((double)y1) + " " +
                 num((double)x2) + " " + num((double)y2)) {}
};

// join a drawable list into one MVG program
inline std::string mvgFromList(const DrawableList& list) {
  std::string out;
  for (DrawableList::const_iterator it = list.begin(); it != list.end();
       ++it) {
    if (!out.empty()) out += " ";
    out += it->mvg();
  }
  return out;
}

}  // namespace Magick

#endif  // MAGICKPP_TORCH_DRAWABLE_H
